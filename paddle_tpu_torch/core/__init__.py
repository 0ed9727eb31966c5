from .flags import define_flag, get_flags, set_flags

__all__ = ["define_flag", "get_flags", "set_flags"]
