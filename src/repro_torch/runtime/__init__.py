"""The runtime pieces the port's paths use, copied from the JAX package's
``runtime``: the failure vocabulary, deterministic fault injection and the
stall watchdog. Bounded retry and the transport come with the slices that
use them."""
from repro_torch.runtime.errors import (DeadlineExceeded,  # noqa: F401
                                        InjectedFault, Overloaded,
                                        StoreStalled)
from repro_torch.runtime.faults import (FaultPlan, FaultSpec,  # noqa: F401
                                        active_plan, clear_plan, fault_point,
                                        inject, install_plan)
from repro_torch.runtime.watchdog import Deadline  # noqa: F401
