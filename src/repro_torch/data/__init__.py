from .synthetic import SyntheticLM, DataState, make_batch_iterator

__all__ = ["SyntheticLM", "DataState", "make_batch_iterator"]
