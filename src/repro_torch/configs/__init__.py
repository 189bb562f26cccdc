"""Model configs of the port (copies of the JAX package's): each module
defines CONFIG and REDUCED."""
from repro_torch.config import ARCH_IDS, get_config, get_reduced_config  # noqa: F401
