"""Run one cell of the benchmark once, on the card this process finds.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

The cell is an entry of ``BENCHMARK.json``; everything it needs is found
by name under ``portbench/`` (see ``portbench/README.md``).  Prints each
number the check compared beside its limit as the last lines of standard
error, and one JSON object as the last line of standard output.  Exits
non-zero, printing no result, without a CUDA card (there is no CPU
fallback), when the program loaded JAX or the JAX package, or on any
fault."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
#: the program's kernel build and any compiler cache stay inside the
#: checkout, at fixed paths (``build/`` is ignored by git)
CACHE = REPO / "build" / "portbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "2")
for p in (REPO / "src", HERE):
    sys.path.insert(0, str(p))

#: top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also read the float8 control over the same "
                    "sample (not part of a benchmark run)")
    a = ap.parse_args(argv)
    from pbench import runner, spec
    cell = spec.load_cell(a.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = runner.run(cell, a.seed, a.seconds, bool(a.trace), dev, T_START,
                     control=a.control)
    bad = loaded_forbidden()
    if bad:
        print(f"the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    runner.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
