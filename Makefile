# Top-level build/test driver (reference: Makefile + Makefile.icc, C17).
# The Python package needs no build; native pieces live under cpp/.

PY ?= python

all: native

native:
	$(MAKE) -C cpp

test: native
	$(PY) -m pytest tests/ -q

bench: native
	$(PY) bench.py

smoke: native
	$(PY) chip_smoke.py

eval:
	$(PY) -m dctz_tpu.eval.harness --suite msst19 --out eval/results_msst19.csv
	$(PY) -m dctz_tpu.eval.harness --suite cesm-atm --out eval/results_cesm.csv

asan:
	$(MAKE) -C cpp asan

clean:
	$(MAKE) -C cpp clean
	rm -rf .pytest_cache dctz_tpu/__pycache__

.PHONY: all native test bench smoke eval asan clean
