"""P2 scheduling (paper §IV) for batched problems: the ``all`` closed form
and the vectorized greedy prefix solver, behind ``schedule``."""
from repro_torch.sched.config import SchedConfig
from repro_torch.sched.greedy import (greedy_solve_batched, pack_coefs,
                                      prefix_sweep)
from repro_torch.sched.problem import BatchedProblem, caps, optimal_bt
from repro_torch.sched.registry import (get_scheduler, list_schedulers,
                                        register_scheduler, schedule)

__all__ = ["BatchedProblem", "SchedConfig", "caps", "get_scheduler",
           "greedy_solve_batched", "list_schedulers", "optimal_bt",
           "pack_coefs", "prefix_sweep", "register_scheduler", "schedule"]
