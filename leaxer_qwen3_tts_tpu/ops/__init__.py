from .attention import attend_xla

__all__ = ["attend_xla"]
