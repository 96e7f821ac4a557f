from repro_torch.data.pipeline import HeteroBatcher
from repro_torch.data.sampler import ProportionalSampler
from repro_torch.data.synthetic import SyntheticImages, SyntheticLM

__all__ = ["HeteroBatcher", "ProportionalSampler", "SyntheticImages", "SyntheticLM"]
