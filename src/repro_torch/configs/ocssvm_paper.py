"""The paper's own experimental configuration (Section 4 / Table 1)."""
from repro_torch.core.kernel_fn import linear
from repro_torch.core.ocssvm import SlabSpec

# Table 1 protocol: linear kernel, nu1=0.5, nu2=0.01, eps=2/3.
PAPER_SPEC = SlabSpec(nu1=0.5, nu2=0.01, eps=2.0 / 3.0, kernel=linear())
# Fig. 2 variant: nu1=0.2, nu2=0.08, eps=1/2.
FIG2_SPEC = SlabSpec(nu1=0.2, nu2=0.08, eps=0.5, kernel=linear())
TABLE1_SIZES = (500, 1000, 2000, 5000)
