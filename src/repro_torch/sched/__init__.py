"""P2 scheduling (paper §IV); port of ``repro.sched``.

The joint worker-scheduling and power-scaling problem as a registry of
solvers behind one entry point (``schedule``): the NumPy float64 oracles
of ``reference`` (Algorithm 1 ``enum``, Algorithm 2 ``admm``, ``greedy``)
on the host, and on the card the batched solvers over a
``BatchedProblem`` of B instances: Algorithm 2 compacted between chunks
(``admm_batched``) or inside the FL round (``admm_batched_jit``), and the
prefix sweep through the prefix_eval kernel (``greedy_batched``).
``scenario`` generates the time-correlated fading that feeds them.
"""
from repro_torch.sched.admm import (AdmmDuals, AdmmSolveInfo,
                                    admm_solve_batched,
                                    admm_solve_batched_jit)
from repro_torch.sched.compaction import (MIN_BUCKET, bucket, pad_to_bucket,
                                          take)
from repro_torch.sched.config import SchedConfig
from repro_torch.sched.greedy import (greedy_solve_batched, pack_coefs,
                                      prefix_sweep)
from repro_torch.sched.problem import BatchedProblem, rt_from_stats
from repro_torch.sched.reference import (Problem, admm_solve,
                                         enumerate_solve,
                                         greedy_prefix_bound, greedy_solve,
                                         optimal_bt)
from repro_torch.sched.registry import (Scheduler, get_scheduler,
                                        list_schedulers, register_scheduler,
                                        schedule)
from repro_torch.sched.scenario import (FadeState, ScenarioConfig, generate,
                                        generate_fades, init_fades,
                                        magnitudes, round_problems,
                                        step_fades)

__all__ = [
    "AdmmDuals", "AdmmSolveInfo", "BatchedProblem", "FadeState", "MIN_BUCKET",
    "Problem", "ScenarioConfig", "SchedConfig",
    "Scheduler", "admm_solve", "admm_solve_batched",
    "admm_solve_batched_jit", "bucket", "enumerate_solve",
    "generate", "generate_fades", "get_scheduler", "greedy_prefix_bound",
    "greedy_solve", "greedy_solve_batched", "init_fades", "list_schedulers",
    "magnitudes", "optimal_bt", "pack_coefs", "pad_to_bucket",
    "prefix_sweep", "register_scheduler", "round_problems", "rt_from_stats",
    "schedule", "step_fades", "take",
]
