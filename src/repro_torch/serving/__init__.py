from repro_torch.serving.disagg import (DecodeWorker,  # noqa: F401
                                        PrefillWorker, Router)
from repro_torch.serving.engine import (TERMINAL_STATUSES,  # noqa: F401
                                        EngineConfig, GenerateResult,
                                        Handoff, RejectedRequest,
                                        RejectReason, Request, RequestSpec,
                                        RequestStatus, ServeEngine,
                                        stitch_prefill_cache)
from repro_torch.serving.faults import (FaultInjector,  # noqa: F401
                                        FaultPlan, InjectedFault)
from repro_torch.serving.paged_cache import (AllocatorError,  # noqa: F401
                                             BlockAllocator,
                                             PagedCacheConfig, pages_for)
