"""The runtime pieces the port's paths use, copied from the JAX package's
``runtime``: the failure vocabulary, deterministic fault injection, bounded
retry and the stall watchdog. The transport comes with the remote
walkers."""
from repro_torch.runtime.errors import (CorruptEpisodeError,  # noqa: F401
                                        DeadlineExceeded, InjectedFault,
                                        Overloaded, StoreStalled)
from repro_torch.runtime.faults import (FaultPlan, FaultSpec,  # noqa: F401
                                        active_plan, clear_plan, fault_point,
                                        inject, install_plan)
from repro_torch.runtime.retry import RetryPolicy, call_with_retry  # noqa: F401
from repro_torch.runtime.watchdog import Deadline  # noqa: F401
