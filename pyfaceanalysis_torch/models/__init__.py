"""Model zoo: SFA/GSFA/PCA nodes, nonlinear expansions, hierarchical networks
(forward, builders, random initialization) and the device-side training
moments and eigensolves (``models.moments``)."""

from pyfaceanalysis_torch.models.expansion import Expansion  # noqa: F401
from pyfaceanalysis_torch.models.network import (  # noqa: F401
    HierarchicalNetwork,
    LayerSpec,
)
from pyfaceanalysis_torch.models.sfa import LinearNode  # noqa: F401
