"""The runtime pieces the port's paths use, copied from the JAX package's
``runtime``: the failure vocabulary, deterministic fault injection, bounded
retry, the stall watchdog, and the remote walkers' transport (checksummed
framing with the ``net.*`` fault sites, exactly-once chunk assembly and the
producer hosts' heartbeat leases)."""
from repro_torch.runtime.errors import (CorruptEpisodeError,  # noqa: F401
                                        DeadlineExceeded, InjectedFault,
                                        Overloaded, StoreStalled,
                                        TransportError)
from repro_torch.runtime.faults import (FaultPlan, FaultSpec,  # noqa: F401
                                        active_plan, clear_plan, fault_point,
                                        inject, install_plan)
from repro_torch.runtime.retry import RetryPolicy, call_with_retry  # noqa: F401
from repro_torch.runtime.transport import (ChunkAssembler,  # noqa: F401
                                           FramedSocket, HostHealth)
from repro_torch.runtime.watchdog import Deadline  # noqa: F401
