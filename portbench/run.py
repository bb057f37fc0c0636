"""Run one cell of the port's benchmark on this machine's CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a ``torch.profiler``
trace of the window (``--record PATH`` also writes that trace's record as
JSON). The last line on stdout is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines on stderr). Without a card, with fewer cards than the
cell asks for, off the cell's route or with a module of JAX or of the JAX
package loaded, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()   # setup_s counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel builds and caches stay at fixed paths inside the checkout: the
# port builds its kernels into build/torch_kernels/ itself
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "cuda_compute"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--record", default=None,
                   help="with --trace 1: write the trace's record here")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "portbench_cache", sub)
    os.environ["DATABEND_TORCH_DEVICE"] = "cuda"
    # the checkout's root, not this folder, heads the path: a module here
    # must not stand in for one of the same name elsewhere
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, ROOT)
    from portbench import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
