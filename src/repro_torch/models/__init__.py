from .zoo import Model, build

__all__ = ["Model", "build"]
