"""The paper's own chip configuration (Fig. 7 summary).

65 nm CMOS, 16 KB single bank of 512x256 6T cells, CORE 1.0 V /
CTRL 0.85 V @ 1 GHz, 8-b data (D) and 8-b streamed input (P).
"""
from repro_torch.core.params import DimaParams

CONFIG = DimaParams()  # defaults are the paper's prototype values
