"""The port's cluster simulator (``repro/sim``)."""
from repro_torch.sim.cluster import (SimProblem, Trace,  # noqa: F401
                                     simulate_anytime, simulate_kbatch)
