"""ldpcsimulation_tpu — LDPC Monte-Carlo simulation framework in JAX.

A from-scratch JAX re-design of the capabilities of
``ereiss123/LDPCsimulation`` (C++/SystemC BER/FER simulators): codeword
generation, BPSK + AWGN channel, LLR computation, and iterative decoders —
sum-product BP, normalized/offset min-sum, the GDBF/NGDBF bit-flip family,
DD-BMP, fixed-point NGDBF hardware emulation, and non-binary FFT-QSPA —
with the Monte-Carlo batch sharded over device meshes.
"""

__version__ = "0.1.0"

from . import codes  # noqa: F401
