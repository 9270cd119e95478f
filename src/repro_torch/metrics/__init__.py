from .success import (success_rate, time_to_solution, energy_to_solution,
                      normalized_ets, tts_distribution, paper_hw_constants)

__all__ = ["success_rate", "time_to_solution", "energy_to_solution",
           "normalized_ets", "tts_distribution", "paper_hw_constants"]
