# Convenience targets (the reference ships a Makefile of CLI binaries,
# Makefile:28; ours maps onto the python package).

PY ?= python
CPU_ENV = JAX_PLATFORMS=cpu

.PHONY: test test-fast test-gpu bench smoke verify-drive clean

test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q -x -m "not slow"

test-gpu:
	JAX_PLATFORMS=cuda,cpu $(PY) -m pytest tests/ -q -m gpu

bench:
	$(PY) bench.py

smoke:
	$(PY) chip_smoke.py

# canonical end-to-end drive vs the C oracle (see .claude/skills/verify)
verify-drive:
	$(CPU_ENV) $(PY) -m bwt_tpu --platform cpu gen_seq 15000 --seed 3 > /tmp/bwt_tpu_g.txt
	$(CPU_ENV) $(PY) -m bwt_tpu --platform cpu build_index /tmp/bwt_tpu_g.txt /tmp/bwt_tpu_ours.idx
	$(PY) -c "import sys; sys.path.insert(0,'tests'); from oracle import oracle; import subprocess; \
subprocess.run([str(oracle('build_index')), '/tmp/bwt_tpu_g.txt', '/tmp/bwt_tpu_ref.idx'], check=True, capture_output=True)"
	cmp /tmp/bwt_tpu_ours.idx /tmp/bwt_tpu_ref.idx && echo "index byte parity OK"

clean:
	rm -rf .oracle .pytest_cache bwt_tpu/native/_libbwtio.so
	find . -name __pycache__ -type d -exec rm -rf {} +
