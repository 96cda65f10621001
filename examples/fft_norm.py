"""Normalization modes — port of the reference's examples/fft_norm.rs:
Default / None / Custom roundtrips give x1, x3, x2 the input."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax

# f64 examples, like the reference's
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from ndrustfft_tpu import FftHandler, Normalization, ndfft, ndifft


def my_norm(data):
    # the reference's custom closure: *= 2/len (examples/fft_norm.rs:36-41)
    return data * (2.0 / data.shape[-1])


def main():
    n = 3
    v = jnp.asarray(np.array([1 + 1j, 2 + 2j, 3 + 3j]))
    print(np.asarray(v))

    for norm, scale, label in [
        (Normalization.DEFAULT, 1.0, "Default"),
        (Normalization.NONE, 3.0, "None"),
        (Normalization.custom(my_norm), 2.0, "Custom"),
    ]:
        handler = FftHandler(n).normalization(norm)
        v2 = ndifft(ndfft(v, handler, axis=0), handler, axis=0)
        print(f"{label}: {np.asarray(v2).round(6)}")
        np.testing.assert_allclose(np.asarray(v2), scale * np.asarray(v),
                                   rtol=1e-9, atol=1e-9)
    print("fft_norm OK")


if __name__ == "__main__":
    main()
