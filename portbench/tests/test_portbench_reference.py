"""The reference against the port at a small size on the CPU, and each
cell's sound run judged correct with every gap at or near 0."""

import pytest
import torch

from portbench import harness
from portbench.reference.tagenv import TagEnv
from portbench.tests.conftest import SEED, SMALL


def _port_env(env_cfg: dict, seed: int, num_envs: int):
    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous

    env = TorchTagContinuous(**{**env_cfg, "seed": seed})
    return EnvEngine(env_obj=env, num_envs=num_envs, seed=seed, device="cpu")


@pytest.mark.parametrize("config", ["tag_continuous", "flagship"])
def test_layout_step_and_observation_equal_the_ports(config):
    cfg = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    env_cfg = cfg["run_config"]["env"] if "run_config" in cfg else cfg["env"]
    seed, E = 987654321, 3
    engine = _port_env(env_cfg, seed, E)
    ref = TagEnv(env_cfg, seed, E, "cpu")
    state = {k: v.clone() for k, v in engine.state.items()
             if k in ref.start}
    for name, want in ref.start.items():
        assert torch.equal(state[name].to(want.dtype), want), name
    gen = torch.Generator().manual_seed(5)
    levels = ref.action_levels
    for _ in range(60):
        actions = torch.stack([torch.randint(0, n, (E, ref.num_agents),
                                             generator=gen)
                               for n in levels], dim=-1).to(torch.int32)
        assert torch.equal(engine.observe(state), ref.observe(state))
        port = engine.step_physics(state, actions)
        mine = ref.step(state, actions)
        for name in mine:
            assert torch.equal(port[name], mine[name]), name
        assert torch.equal(ref.infer_actions(state, port)[..., :],
                           ref.infer_actions(state, mine))
        state = ref.reset_done({k: port[k] for k in mine})


def test_inferred_actions_reproduce_the_step():
    cfg = harness.load_json(harness.HERE / "configs" / "flagship.json")
    ref = TagEnv(cfg["env"], 42, 2, "cpu")
    gen = torch.Generator().manual_seed(1)
    state = {k: v.clone() for k, v in ref.start.items()}
    for _ in range(20):
        actions = torch.stack([torch.randint(0, n, (2, ref.num_agents),
                                             generator=gen)
                               for n in ref.action_levels], dim=-1)
        post = ref.step(state, actions)
        again = ref.step(state, ref.infer_actions(state, post))
        for name in post:
            assert torch.equal(post[name], again[name]), name
        state = ref.reset_done(post)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    line = harness.execute(cell, SEED, 1.0, False, device="cpu",
                           overrides=SMALL[cell], settle=False)
    assert line["correct"], line["checks"]
    checks = line["checks"]
    assert checks["mismatches"]["value"] == 0
    assert checks["obs_gap"]["value"] == 0
    # the last line's keys, the compared numbers last
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    assert "setup_s" in line["metrics"]
