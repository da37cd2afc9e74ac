# CI entry points (see ROADMAP.md "Tier-1 verify" and DESIGN.md §9),
# enforced on push/PR by .github/workflows/ci.yml.
#
#   make test         tier-1 test suite (the gate every PR must keep green;
#                     includes the public-API surface snapshot,
#                     tests/test_api_surface.py vs tests/api_surface.json)
#   make test-torch   the PyTorch/CUDA port's differential tests only
#                     (tests/test_torch_*.py: port vs reference, on the CPU)
#   make dryrun-torch the port's dry run of every cell on the production
#                     meshes, on the CPU (meta tensors, no GPU): 80 records
#                     appended to build/dryrun/dryrun.jsonl
#   make bench-smoke  SCALE-parameterized run of every benchmark section
#                     (default tiny) — catches import rot and shape bugs in
#                     minutes, not numbers; writes BENCH_<section>.json
#                     (uploaded as CI artifacts).  CI runs it twice: tiny,
#                     then SCALE=small so the paged-twohop acceptance row
#                     (table > 8 MB, kernel_fallbacks=0) is exercised on
#                     every push.
#   make bench        paper-scale benchmark run (small suite)
#   make bench-report roofline achieved-vs-peak table from the JSON dumps
#   make chaos        fault-injection sweep (DESIGN.md §14.5): runs
#                     tests/test_chaos.py once per fault class in
#                     CHAOS_FAULTS under both kernel backends; dead-letter
#                     queues are exported to deadletters/ (CI artifacts)

PYTHONPATH := src
export PYTHONPATH

SCALE ?= tiny
PEAK_GBS ?= 50
CHAOS_FAULTS ?= kernel.fallback cap.exhaust ovf.exhaust color.corrupt \
	service.step service.submit
CHAOS_BACKENDS ?= pallas_interpret jnp

.PHONY: test test-torch dryrun-torch bench-smoke bench bench-report chaos

test:
	python -m pytest -x -q

test-torch:
	python -m pytest -q tests/test_torch_*.py

dryrun-torch:
	python -m repro_torch.launch.dryrun --all --multi-pod both \
	    --out build/dryrun/dryrun.jsonl --skip-done

chaos:
	@mkdir -p deadletters
	@for f in $(CHAOS_FAULTS); do \
	  for b in $(CHAOS_BACKENDS); do \
	    echo "=== chaos: $$f ($$b) ==="; \
	    REPRO_FAULTS="$$f:p=0.5:seed=7" \
	    REPRO_KERNEL_BACKEND="$$b" \
	    REPRO_DEADLETTER_DIR=deadletters \
	    python -m pytest tests/test_chaos.py -q || exit 1; \
	  done; \
	done

bench-smoke:
	python -m benchmarks.run --scale=$(SCALE) --json

bench:
	python -m benchmarks.run --scale=small

bench-report:
	python -m benchmarks.roofline_report --bench BENCH_*.json \
	  --peak-gbs $(PEAK_GBS) | tee roofline_bench.md
