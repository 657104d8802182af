#!/bin/bash
# One-shot hardware sweep on the GPU: the on-card smoke run, the headline
# bench and every tools/bench_* run, each in a FRESH process (one JAX
# process on the card at a time) under a timeout.  Artifacts land as
# *_r${LIBSDR_ROUND:-05}.json at the repository root.
#
# Usage: bash tools/bench_all.sh [quick]
#   quick: skip the smoke run, run benches only.
set -u
cd "$(dirname "$0")/.."
PY=${PYTHON:-python}

run() {  # run <timeout_s> <name> <cmd...>
  local t=$1 name=$2; shift 2
  echo "=== $name ==="
  timeout "$t" "$@"
  echo "=== $name exit=$? ==="
}

if [ "${1:-}" != "quick" ]; then
  run 1200 smoke $PY chip_smoke.py
fi
run 600 headline      $PY bench.py
run 600 rx_modes      $PY tools/bench_rx_modes.py
run 600 channelizer   $PY tools/bench_channelizer.py
run 900 decoder_bank  $PY tools/bench_decoder_bank.py --channels 1024
run 600 multimode     $PY tools/bench_multimode.py
run 600 streaming     $PY tools/bench_streaming.py
run 300 live_ingest   $PY tools/bench_live_ingest.py
# Virtual-mesh scaling harness (structural-only on CPU; the artifact
# carries that annotation).
run 300 scaling env JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  LIBSDR_ALLOW_CPU_ARTIFACT=1 $PY tools/bench_scaling.py
echo "sweep done; artifacts:"
ls -la *_r"${LIBSDR_ROUND:-05}".json 2>/dev/null
