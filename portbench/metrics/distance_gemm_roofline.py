"""``distance_gemm_roofline``: the f32 distance product's share of its
roofline. The least time of each ``aten::mm`` in the traced window (its 2
b n d FLOPs at the H100's 67 TFLOP/s f32 peak, or its operands read once
and its block written once at 3.35 TB/s, whichever is larger), summed, over
the device time of the product kernels (cuBLAS names: ``gemm``, ``splitK``)
in the window. Layer: ops, the f32 distance product
(``ops/distance.pairwise_product``, cuBLAS)."""

from portbench import peaks
from portbench.devtrace import in_window, products


def read(record):
    if not record.get("window_us"):
        return None
    mms = products(record)
    kernels = [e - s for name, s, e in in_window(record["device"],
                                                   record["window_us"])
               if "gemm" in name.lower() or "splitk" in name.lower()]
    if not mms or not kernels:
        return None
    least = sum(peaks.f32_gemm_bound(b, n, d)[0] for b, d, n in mms)
    return 100.0 * least / (sum(kernels) / 1e6)
