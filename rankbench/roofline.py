"""The yardstick's peaks and the work a ranking needs.

Peaks are the NVIDIA H100 SXM data sheet's (dense rates, 700 W): HBM3 at
3.35 TB/s, 34 TFLOP/s in float64 and 67 TFLOP/s in float32, both outside
the tensor cores, which a sparse product cannot use. A share of the
roofline is stated against these, with the card's power limit beside it.

The work is what the crawl needs, whatever stores or computes it: for
each of a sweep's two products (a = L^T (h * ch), h' = L (a * ca)) each
link's index once and 2 operations a link; the vectors h, ch, a and ca
read once and a and h' written once. L is the crawl's 0/1 link matrix,
so a link carries no weight to read: Ca and Ch are per-page vectors,
counted among the vectors. The 128 x 128 blocks that the program stores
are not counted, so a program that stores the crawl in fewer bytes reads
a higher share, never one above 100 %.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
ITEMSIZE = {"float64": 8, "float32": 4}
INDEX_BYTES = 4


def sweep_bytes(pages: int, links: int, dtype: str = "float64") -> int:
    """Bytes one accelerated-HITS sweep needs to move over a crawl."""
    products = 2 * links * INDEX_BYTES
    vectors = (4 + 2) * pages * ITEMSIZE[dtype]
    return products + vectors


def sweep_flops(links: int) -> int:
    """Operations of one sweep: a multiply and an add a link a product."""
    return 2 * 2 * links


def sweep_seconds(pages: int, links: int, dtype: str = "float64") -> float:
    """The least time one sweep can take on the card: the larger of its
    bytes over the HBM rate and its operations over the peak rate."""
    return max(sweep_bytes(pages, links, dtype) / HBM_BYTES_PER_S,
               sweep_flops(links) / PEAK_FLOPS[dtype])
