# Convenience targets.

test:            ## CPU test suite (8 virtual devices; kernels interpreted)
	python -m pytest tests/ -q

smoke:           ## the closed loop on the GPU, checked and timed
	python chip_smoke.py

.PHONY: test smoke
