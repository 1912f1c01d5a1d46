"""Sampler registry (counterpart of ``tvc/samplers/__init__.py``)."""

from tvc_torch.samplers.ancestral import ddpm_sampler
from tvc_torch.samplers.schedules import Schedule, SubSchedule, get_sigmas

_SAMPLERS = {"DDPM": ddpm_sampler}
_NOT_PORTED = ("DDIM", "FPNDM", "SMLD")


def get_sampler(version: str):
    v = version.upper()
    if v in _SAMPLERS:
        return _SAMPLERS[v]
    if v in _NOT_PORTED:
        raise NotImplementedError(
            f"sampler {v} is not ported yet (ROADMAP.md, queue A, capability surface)")
    raise ValueError(f"unknown sampler version: {version}")


__all__ = ["Schedule", "SubSchedule", "get_sigmas", "get_sampler", "ddpm_sampler"]
