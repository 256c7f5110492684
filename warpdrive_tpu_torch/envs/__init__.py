"""Environment package: importing registers the ported env families."""


def register_all_envs():
    """Import every ported env module so they self-register."""
    import warpdrive_tpu_torch.envs.asymmetric_pursuit  # noqa: F401
    import warpdrive_tpu_torch.envs.chem_search  # noqa: F401
    import warpdrive_tpu_torch.envs.classic_control.acrobot  # noqa: F401
    import warpdrive_tpu_torch.envs.classic_control.cartpole  # noqa: F401
    import warpdrive_tpu_torch.envs.classic_control.continuous_mountain_car  # noqa: F401,E501
    import warpdrive_tpu_torch.envs.classic_control.mountain_car  # noqa: F401
    import warpdrive_tpu_torch.envs.classic_control.pendulum  # noqa: F401
    import warpdrive_tpu_torch.envs.dummy_env  # noqa: F401
    import warpdrive_tpu_torch.envs.tag_continuous  # noqa: F401
    import warpdrive_tpu_torch.envs.tag_gridworld  # noqa: F401
