"""Environment package: importing registers the ported env families."""


def register_all_envs():
    """Import every ported env module so they self-register."""
    import warpdrive_tpu_torch.envs.tag_continuous  # noqa: F401
