"""The paper's own architecture: 64-spin all-to-all Ising machine (digital
twin), plus a pod-scale 4096-spin virtual chip array (64x64 tiles of the
64-spin die) — the cell most representative of the paper's technique."""
from .base import ModelConfig

CONFIG = ModelConfig(name="ising64", family="ising")

# solve-shape registry (problems P x runs R per solve batch)
ISING_SHAPES = {
    # paper protocol: 20 problems x 1000 LFSR runs, 64 spins
    "chip64": dict(n_spins=64, problems=256, runs=1024),
    # pod-scale virtual chip array: 4096 spins (64x64 dies), fewer runs
    "array4096": dict(n_spins=4096, problems=32, runs=128),
}
