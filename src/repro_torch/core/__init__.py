"""Core: digital twin of the 64-spin all-to-all CMOS Ising machine."""
from .device_model import (DEFAULT_DEVICE, DeviceModel, anneal_time_seconds,
                           chip_power_watts)
from .perturbation import (DEFAULT_PERTURBATION, NOMINAL, PerturbationConfig,
                           column_scales, scales_from_cols, schedule_table,
                           unit_scales)
from .annealer import AnnealResult, anneal, anneal_energy_trace
from .engine import AnnealEngine, EnginePlan
from .machine import IsingMachine, SolveOutput
from .hamiltonian import (absorb_fields, fix_gauge, flip_deltas, ising_energy,
                          local_field, maxcut_to_ising, maxcut_value,
                          qubo_to_ising)
from .lfsr import lfsr64_states, lfsr_spin_inits, lfsr_voltage_inits

__all__ = [
    "DeviceModel", "DEFAULT_DEVICE", "chip_power_watts", "anneal_time_seconds",
    "PerturbationConfig", "DEFAULT_PERTURBATION", "NOMINAL", "column_scales",
    "scales_from_cols", "schedule_table", "unit_scales",
    "anneal", "AnnealResult", "anneal_energy_trace",
    "AnnealEngine", "EnginePlan",
    "IsingMachine", "SolveOutput", "ising_energy", "local_field", "flip_deltas",
    "qubo_to_ising", "maxcut_to_ising", "maxcut_value", "absorb_fields",
    "fix_gauge", "lfsr_spin_inits", "lfsr_voltage_inits", "lfsr64_states",
]
