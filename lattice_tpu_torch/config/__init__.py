from lattice_tpu_torch.config.settings import Settings, get_settings, reset_settings

__all__ = ["Settings", "get_settings", "reset_settings"]
