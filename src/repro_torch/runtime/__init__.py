"""The runtime pieces the port's paths use, copied from the JAX package's
``runtime``: the failure vocabulary and the stall watchdog. Fault injection
(``faults.py``), bounded retry and the transport come with the slices that
use them."""
from repro_torch.runtime.errors import (DeadlineExceeded,  # noqa: F401
                                        StoreStalled)
from repro_torch.runtime.watchdog import Deadline  # noqa: F401
