#!/usr/bin/env bash
# CI entry point of the port (repro_torch), the counterpart of scripts/ci.sh
# without its benchmark steps:
#
#   bash port/ci.sh          on the machine with the card: the static gates,
#                            the GPU-marked kernel tests, both correctness
#                            gates on the card
#   bash port/ci.sh --cpu    anywhere: the static gates, the port's CPU tests
#                            (parity against the JAX package), both gates on
#                            the CPU
#
# There is no detection of the card: without --cpu, a machine with no card
# fails at the first step that needs it.  Every step's failure fails the run.
#
# Left out until the port has its own benchmark (ROADMAP Queue 1 item 1):
# scripts/ci.sh's `benchmarks.run` steps (gc, dist_recovery, serve, ycsb,
# serve_obs), the obs overhead gate (scripts/check_obs_overhead.py, which
# reads serve_obs's artifact) and the trajectory gate
# (scripts/check_bench_regression.py, which reads benchmarks/baselines/).
set -euo pipefail
cd "$(dirname "$0")/.."

device=cuda
if [ "${1:-}" = "--cpu" ]; then
    device=cpu
elif [ -n "${1:-}" ]; then
    echo "usage: bash port/ci.sh [--cpu]" >&2
    exit 2
fi

# static gates first — the cheapest, and each names the invariant it guards
# (port/repro_torch/analysis/README.md): bourbonlint with zero unbaselined
# findings on port/repro_torch, and no module outside the dead-module
# allowlist unreachable
python port/scripts/lint.py --baseline port/.bourbonlint-baseline.json
python port/scripts/lint.py --report dead-modules
# mypy: strict on repro_torch.analysis, checked on storage/obs
# (port/mypy.ini); the image may not ship mypy — warn-skip, never install
if python -c "import mypy" 2>/dev/null; then
    python -m mypy --config-file port/mypy.ini \
        port/repro_torch/analysis port/repro_torch/storage \
        port/repro_torch/obs
else
    echo "WARN: mypy not installed — skipping type gate"
fi

if [ "$device" = cuda ]; then
    # the kernels against their plain versions, the CUDA store against the
    # CPU store, the dispatch halves under the sync debug mode
    python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py
else
    # the port against the reference on the CPU, spread as the tier-1 run
    # spreads it (one process takes far longer), then the serving tests
    # alone so that a serving regression is named
    JAX_PLATFORMS=cpu PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH} \
        python -m pytest -q -p xdist -n 6 --dist loadfile \
        tests/test_torch_*.py
    JAX_PLATFORMS=cpu PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH} \
        python -m pytest -q tests/test_torch_server.py \
        tests/test_torch_pipeline.py tests/test_torch_obs.py
fi

# host I/O plane determinism gate: the threaded read path (io_workers 1
# and 4) and the group-commit WAL committer must produce byte-identical
# results to the inline path (io_workers=0) with epoch_violations == 0
python port/scripts/check_io_determinism.py --device "$device"

# filter plane zero-false-negative gate: filters on vs off byte-identical
# on a mixed present/absent/deleted workload (the host-answer path and the
# device maybe-mask path), and a reopened store serves recovered filters
# with zero rebuilds
python port/scripts/check_filter_zero_fn.py --device "$device"
