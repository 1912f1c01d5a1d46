"""Sampler registry (counterpart of ``tvc/samplers/__init__.py``)."""

from tvc_torch.samplers.ancestral import ddim_sampler, ddpm_sampler
from tvc_torch.samplers.langevin import anneal_langevin_dynamics, sparse_anneal_langevin_dynamics
from tvc_torch.samplers.pndm import fpndm_sampler
from tvc_torch.samplers.schedules import Schedule, SubSchedule, get_sigmas

_SAMPLERS = {
    "DDPM": ddpm_sampler,
    "DDIM": ddim_sampler,
    "FPNDM": fpndm_sampler,
    "SMLD": anneal_langevin_dynamics,
}


def get_sampler(version: str):
    try:
        return _SAMPLERS[version.upper()]
    except KeyError:
        raise ValueError(f"unknown sampler version: {version}") from None


__all__ = [
    "Schedule",
    "SubSchedule",
    "get_sigmas",
    "get_sampler",
    "ddpm_sampler",
    "ddim_sampler",
    "fpndm_sampler",
    "anneal_langevin_dynamics",
    "sparse_anneal_langevin_dynamics",
]
