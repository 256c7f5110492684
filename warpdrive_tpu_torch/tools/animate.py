"""
Rollout visualization for the Tag environments: the port's counterpart of
``warpdrive_tpu/tools/animate.py``.  One episode of the trained policies
(``trainer.fetch_logged_episode()`` when the env logs ``loc_x``, ``loc_y``
and ``still_in_the_game`` across the episode, else
``trainer.fetch_episode_states``) rendered as a matplotlib animation of the
taggers' and runners' positions.  matplotlib is imported when a rollout is
drawn, never with the module.
"""

from __future__ import annotations

import numpy as np

_TRACKS = ("loc_x", "loc_y", "still_in_the_game")


def generate_tag_rollout_animation(
    trainer,
    fps: int = 20,
    tagger_color: str = "#C843C3",
    runner_color: str = "#245EB6",
    runner_exit_color: str = "#666666",
    fig_size: tuple = (6, 6),
):
    """Replay one episode of a Tag env and return a
    ``matplotlib.animation.FuncAnimation``.

    Works for any env with ``loc_x``, ``loc_y`` and ``still_in_the_game``
    state arrays and an ``agent_types`` attribute (TagContinuous;
    TagGridWorld through its integer locations)."""
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    env = trainer.engine.env
    if set(_TRACKS) <= set(trainer.engine.store.log_names):
        episode = trainer.fetch_logged_episode()
    else:
        episode = trainer.fetch_episode_states(list(_TRACKS))
    loc_x = np.asarray(episode["loc_x"], dtype=np.float32)
    loc_y = np.asarray(episode["loc_y"], dtype=np.float32)
    still = np.asarray(episode["still_in_the_game"])
    n_steps, n_agents = loc_x.shape

    agent_types = np.asarray(
        [env.agent_type[i] for i in range(n_agents)]
        if isinstance(getattr(env, "agent_type", None), dict)
        else env.agent_types
    )
    is_tagger = agent_types == 1

    fig, ax = plt.subplots(figsize=fig_size)
    grid = float(getattr(env, "grid_length", max(loc_x.max(), loc_y.max())))
    ax.set_xlim(0, grid)
    ax.set_ylim(0, grid)
    ax.set_xticks([])
    ax.set_yticks([])

    runners = ax.scatter([], [], s=18, c=runner_color, label="runners")
    exited = ax.scatter([], [], s=10, c=runner_exit_color, marker="x")
    taggers = ax.scatter([], [], s=40, c=tagger_color, label="taggers")
    title = ax.set_title("")
    ax.legend(loc="upper right")

    def update(t):
        alive = still[t] > 0
        run_mask = ~is_tagger & alive
        out_mask = ~is_tagger & ~alive
        runners.set_offsets(np.c_[loc_x[t, run_mask], loc_y[t, run_mask]])
        exited.set_offsets(np.c_[loc_x[t, out_mask], loc_y[t, out_mask]])
        taggers.set_offsets(np.c_[loc_x[t, is_tagger], loc_y[t, is_tagger]])
        title.set_text(
            f"step {t}/{n_steps - 1} — runners left: {int(run_mask.sum())}"
        )
        return runners, exited, taggers, title

    return animation.FuncAnimation(
        fig, update, frames=n_steps, interval=1000 // fps, blit=False
    )
