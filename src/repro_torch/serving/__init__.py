from repro_torch.serving.engine import (GenerateResult,  # noqa: F401
                                        RejectedRequest, RejectReason,
                                        Request, RequestSpec, RequestStatus,
                                        ServeEngine)
from repro_torch.serving.paged_cache import (AllocatorError,  # noqa: F401
                                             BlockAllocator,
                                             PagedCacheConfig, pages_for)
