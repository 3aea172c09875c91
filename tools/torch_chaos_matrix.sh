#!/usr/bin/env bash
# Chaos matrix for the PyTorch port: sweep the fault-site x schedule
# matrix with distinct seeds and fail on ANY unrecovered scenario. The
# port's counterpart of tools/chaos_matrix.sh, with the same default seeds,
# the same fifteen site groups and the same scenario group.
#
# The port's chaos tests read TCSDN_CHAOS_SEED: count schedules fire
# identically at every seed, while probability schedules
# (`FaultRule(p=...)`) draw from the plan's seeded RNG, so sweeping the
# seed drives different crash subsets of the same scenarios. The recovery
# invariants must hold for EVERY seed.
#
# Usage: tools/torch_chaos_matrix.sh [seed ...]   (default: 0 1 2 7 1337)
#
# Each seed runs each site group once, so a failure names both the seed
# and the seam that broke. A group is `name|test files|-k expression`,
# run with `-m chaos`: the port keeps a site's tests in the test file of
# the module that holds the site, so a group spans those files. A group
# whose -k selects no test fails the sweep (pytest exits 5).
# tests/test_torch_chaos_matrix.py checks, without a sweep, that every
# group selects a test and that the groups cover every site of the
# port's utils/faults.SITES.
#
# Every group runs with TCSDN_LOCKTRACE=1 and TCSDN_SYNCGUARD=1, so the
# port's lock-order witness (utils/locktrace.py) and sync witness
# (utils/syncguard.py) watch every crash and recovery interleaving the
# sweep drives. The sweep runs on the CPU (JAX_PLATFORMS=cpu for the
# tests that compare with the JAX package).
set -euo pipefail
cd "$(dirname "$0")/.."

SEEDS=("$@")
if [ ${#SEEDS[@]} -eq 0 ]; then
  SEEDS=(0 1 2 7 1337)
fi

CHAOS=tests/test_torch_chaos.py
GROUPS_KEYS=(
  "checkpoint|$CHAOS tests/test_torch_checkpoint.py tests/test_torch_sgd.py|kill_mid_write or rename_fault or probabilistic_save or restore_fault or killed_jax_rotation or killed_save or snapshot_fault or train_ckpt or train_state"
  "collector|tests/test_torch_collector.py|torn_read or died_mid_line"
  "supervisor|tests/test_torch_collector.py|backoff_ladder"
  "native|tests/test_torch_native_engine.py|native_load"
  "pipeline|$CHAOS tests/test_torch_pipeline.py|pipeline_handoff or coalesced_render"
  "degrade|$CHAOS tests/test_torch_degrade.py|degrade_dispatch or fault_sites_demote or armed_dispatch_error"
  "drift|$CHAOS|drift_window or killed_fit or promote_swap or promote_rollback or drift_loop"
  "dirty|$CHAOS tests/test_torch_incremental.py|serve_dirty_mask or faults_are_absorbed"
  "fanin|$CHAOS tests/test_torch_fanin.py|fanin_put or source_dead"
  "region|$CHAOS|region_source_dead or region_dirty_mask or region_fanin_put"
  "native_ingest|$CHAOS tests/test_torch_native_engine.py|native_parse or parse_fault"
  "obs|$CHAOS tests/test_torch_obs_serve.py|obs_stamp or sigusr1"
  "obsdev|$CHAOS tests/test_torch_device_obs.py|perf_ring or profiler"
  "openset|$CHAOS tests/test_torch_openset.py|openset_faults or openset_probabilistic or fault_sites_are_absorbed"
  "actuation|$CHAOS|actuation_send or actuation_barrier or actuation_retract or actuation_probabilistic"
)

fail=0
for seed in "${SEEDS[@]}"; do
  for entry in "${GROUPS_KEYS[@]}"; do
    IFS='|' read -r site files kexpr <<< "$entry"
    echo "=== chaos seed=${seed} site=${site}"
    # shellcheck disable=SC2086  # files is a space-separated list
    if ! TCSDN_CHAOS_SEED="$seed" TCSDN_LOCKTRACE=1 TCSDN_SYNCGUARD=1 \
        JAX_PLATFORMS=cpu \
        python -m pytest $files -q -m chaos -k "$kexpr" \
        -p no:cacheprovider; then
      echo "!!! UNRECOVERED: seed=${seed} site=${site}" >&2
      fail=1
    fi
  done
done

# scenario campaign group: the composed adversarial timelines of
# tests/test_torch_scenarios.py through the port's real fan-in pumps,
# serve loop and ladder threads, under the same witnesses. One sweep
# suffices: the timelines are deterministic on the virtual clock, only
# thread interleavings vary.
echo "=== chaos site=scenario (campaign timelines)"
if ! TCSDN_LOCKTRACE=1 TCSDN_SYNCGUARD=1 JAX_PLATFORMS=cpu \
    python -m pytest tests/test_torch_scenarios.py -q \
    -p no:cacheprovider; then
  echo "!!! UNRECOVERED: site=scenario" >&2
  fail=1
fi

if [ "$fail" -ne 0 ]; then
  echo "torch chaos matrix: FAILURES (see above)" >&2
  exit 1
fi
echo "torch chaos matrix: all scenarios recovered (seeds: ${SEEDS[*]})"
