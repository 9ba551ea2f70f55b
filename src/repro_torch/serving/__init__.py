from repro_torch.serving.engine import (GenerateResult,  # noqa: F401
                                        RejectedRequest, RejectReason,
                                        Request, RequestSpec, RequestStatus,
                                        ServeEngine)
