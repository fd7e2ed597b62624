"""meshclust_tpu_torch: the PyTorch and CUDA port of meshclust_tpu for
NVIDIA Hopper (H100).

DNA sequence mean-shift clustering with the capabilities of
BioinformaticsToolsmith/MeShClust (James et al., NAR 2018). The JAX package
meshclust_tpu beside it is the reference that each part of this port is
tested against.
"""

__version__ = "0.1.0"

from meshclust_tpu_torch.config import ClusterConfig  # noqa: F401,E402
