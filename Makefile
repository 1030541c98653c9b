# Developer entry points. `hypothesis` is an OPTIONAL dev dependency: the
# property tests use it when installed and fall back to deterministic fixed
# examples (tests/_hypothesis_compat.py) when not.

PY ?= python

.PHONY: test test-fast test-slow bench ci lint plan-demo calibrate-smoke trace-demo

test:            ## tier-1 gate: full suite, stop on first failure
	$(PY) -m pytest -x -q

test-fast:       ## quick signal (<60s): skip the slow end-to-end tests
	$(PY) -m pytest -x -q -m "not slow"

test-slow:       ## the slow tier only (marked end-to-end tests)
	$(PY) -m pytest -x -q -m "slow"

bench:           ## paper-claim checks; nonzero exit on mismatch
	PYTHONPATH=src $(PY) -m benchmarks.run

lint:            ## ruff (when installed) + the static gates of both packages
	@if command -v ruff >/dev/null 2>&1; then \
		ruff check src benchmarks examples; \
	else \
		echo "lint: ruff not installed, skipping (config pinned in pyproject.toml)"; \
	fi
	PYTHONPATH=src $(PY) -m repro.analysis src/repro
	PYTHONPATH=src $(PY) -m repro_torch.analysis src/repro_torch

calibrate-smoke: ## measure this box + fit achievable ceilings (<60s, CPU)
	PYTHONPATH=src $(PY) -m repro.measure.calibrate --backend cpu --smoke --devices 4

# The fast tier is wall-clock budgeted inside ci.sh (FAST_BUDGET_S, default
# 75s) and reports its slowest tests via --durations=10: a test that belongs
# in the slow tier fails CI instead of silently bloating tier-1.
ci: 	         ## what CI runs: tests, calibration smoke, benchmarks
	bash scripts/ci.sh

plan-demo:
	PYTHONPATH=src $(PY) examples/plan_demo.py

trace-demo:      ## traced+explained planner run -> artifacts/traces/ (perfetto-loadable)
	mkdir -p artifacts/traces
	PYTHONPATH=src $(PY) -m repro.launch.plan --arch qwen2-7b \
		--hardware tpu_v5e --chips 16 --batch 8 --seq 128 --zero auto \
		--explain --trace artifacts/traces/plan_demo.trace.json
	PYTHONPATH=src $(PY) -m repro.obs --validate artifacts/traces/plan_demo.trace.json
