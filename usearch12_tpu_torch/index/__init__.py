from .udb import UDBParams, UDBIndex  # noqa: F401
