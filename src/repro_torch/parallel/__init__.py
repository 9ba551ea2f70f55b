"""Ranks, process groups and the collectives of the MoE transports: the
port's counterpart of ``repro.parallel``, over ``torch.distributed``."""
