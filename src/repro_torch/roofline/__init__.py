"""Roofline terms of a step on the H100 (the reference's ``roofline``):
``op_cost.analyze`` counts one eager run's FLOPs, bytes and collectives;
``analysis`` turns the count into compute / memory / collective times
against ``HW`` and holds the 6ND / 2ND yardstick (``model_flops``)."""
from .analysis import (HW, active_params, collective_bytes, count_params,
                       model_flops, roofline_report)
from .op_cost import Cost, analyze

__all__ = ["HW", "collective_bytes", "roofline_report", "model_flops",
           "count_params", "active_params", "Cost", "analyze"]
