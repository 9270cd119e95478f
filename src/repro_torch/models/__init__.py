from .zoo import Model, build, cache_specs, input_specs

__all__ = ["Model", "build", "cache_specs", "input_specs"]
