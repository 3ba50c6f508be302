from repro_torch.kernels.ssd_scan.kernel import (ssd_intra_chunk,
                                                 ssd_intra_chunk_plain)
from repro_torch.kernels.ssd_scan.ops import chunk_len, ssd_chunked_kernel

__all__ = ["chunk_len", "ssd_chunked_kernel", "ssd_intra_chunk",
           "ssd_intra_chunk_plain"]
