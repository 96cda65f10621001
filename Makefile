# ndrustfft_tpu build/test entry points

NATIVE_SO = ndrustfft_tpu/native/libndplanner.so

.PHONY: all native test bench examples clean

all: native

native: $(NATIVE_SO)

$(NATIVE_SO): ndrustfft_tpu/native/planner.cpp
	g++ -O2 -shared -fPIC -o $@ $<

# the tests run on the host CPU (8 virtual devices, tests/conftest.py)
test: native
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

# on one NVIDIA GPU; `python chip_smoke.py --four` needs four
smoke: native
	python chip_smoke.py

bench: native
	python bench.py

examples: native
	python examples/fft1.py && python examples/fft2.py && \
	python examples/rfft2.py && python examples/fft_norm.py && \
	python examples/poisson.py && python examples/any_n.py && \
	python examples/vorticity2d.py && python examples/poisson_dirichlet.py && \
	XLA_FLAGS=--xla_force_host_platform_device_count=8 python examples/pencil3d.py

clean:
	rm -f $(NATIVE_SO)
	find . -name __pycache__ -type d -exec rm -rf {} +
