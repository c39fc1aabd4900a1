"""Named code registry backed by packaged data files and constructions.

The reference ships fixed parity-check matrices under
``C_implementations/codes/`` (PEGReg504x1008, MacKay 4000.2000.4.244,
802.3an, DVB-S2, 802.11n — SURVEY §2.5).  This framework is self-contained:
equivalent codes are either generated by construction (PEG/QC) or packaged as
data produced by those constructions.  ``load_alist`` still accepts any
external alist (including the reference's own files) for exact-H parity runs.
"""

from __future__ import annotations

import functools
import os

from .alist import load_alist
from .code import Code, build_code
from .construct import peg, random_regular

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")

__all__ = ["data_path", "load_named_code", "NAMED_CODES"]


def data_path(name: str) -> str:
    return os.path.join(_DATA_DIR, name)


@functools.lru_cache(maxsize=None)
def load_named_code(name: str) -> Code:
    """Load a registered code by name (cached)."""
    if name not in NAMED_CODES:
        raise KeyError(f"unknown code {name!r}; have {sorted(NAMED_CODES)}")
    return NAMED_CODES[name]()


def _from_data(filename: str) -> Code:
    return build_code(load_alist(data_path(filename)))


@functools.lru_cache(maxsize=None)
def load_named_qc(name: str):
    """QC structure objects (see ..codes.qc) for QC-registered codes (cached:
    PEG construction + the girth-6 shift search are deterministic and cost
    seconds for the large classes)."""
    from .qc import qc_peg

    if name == "qc_1008_504":
        # z=84 (6x12 base): fewer, larger blocks than z=42; BER measured
        # equal at 2.0 and 2.4 dB (2.396e-2 vs 2.388e-2; 4.90e-3 vs
        # 5.05e-3, 66M bits each).  It defines the flagship configuration.
        return qc_peg(12, 6, 3, z=84, seed=1)
    if name == "wifi_like_1944_972":
        from .qc import qc_ira

        # 802.11n rate-1/2 class: 12x24 base, z=81 (structure per the
        # standard, shift table our own girth-6 search — see qc_ira)
        return qc_ira(nb_info=12, mb=12, z=81, dv_info=4, seed=2)
    if name == "dvbs2_like_64800_32400":
        # DVB-S2 rate-1/2 size class (64800, 32400) as a dv=3 QC ensemble
        # code (PEG protograph 60x120, z=540); the standard's own IRA
        # tables can be loaded from any alist via load_alist instead
        return qc_peg(120, 60, 3, z=540, seed=4)
    if name == "wifi_648_324":
        # the REAL IEEE 802.11n rate-1/2 z=27 code (codes/standards.py)
        from .standards import wifi_648_rate12_qc

        return wifi_648_rate12_qc()
    if name == "wifi_1944_972":
        # the REAL IEEE 802.11n rate-1/2 z=81 code (codes/standards.py)
        from .standards import wifi_1944_rate12_qc

        return wifi_1944_rate12_qc()
    if name == "dvbs2_1_2_qc":
        # the REAL DVB-S2 rate-1/2 code in its QC-interleaved column order
        # (generalized z=360 structure: multi-edge blocks + the
        # accumulator-corner defect; bit-flip roll ops only).  Column
        # relabeling of dvbs2_1_2 — identical BER/FER statistics; use
        # standards.dvbs2_rate12_qc() + qc_detect.permuted_decoder for
        # natural-order frames.
        from .standards import dvbs2_rate12_qc

        return dvbs2_rate12_qc().qc
    raise KeyError(name)


NAMED_CODES = {
    # flagship benchmark code: PEG-constructed (1008, 504) regular dv=3 —
    # the same ensemble/size as the reference's PEGReg504x1008 (the BASELINE
    # metric configuration)
    "peg_1008_504": lambda: _from_data("peg_1008_504.alist"),
    # QC flagship: same (1008, 504) dv=3 girth-6 ensemble, quasi-cyclic
    # (PEG protograph 12x24, z=42) — enables the gather-free decoder
    "qc_1008_504": lambda: load_named_qc("qc_1008_504").to_code(),
    # 802.11n-class (1944, 972) IRA/QC code (layered-vs-flooding config)
    "wifi_like_1944_972": lambda: load_named_qc("wifi_like_1944_972").to_code(),
    # small test codes, generated on the fly
    "peg_96_48": lambda: build_code(peg(96, 48, 3, seed=0)),
    "peg_24_12": lambda: build_code(peg(24, 12, 3, seed=0)),
    # MacKay 4000.2000 analog: (4,8)-regular ensemble
    "reg4_4000_2000": lambda: build_code(random_regular(4000, 2000, 4, seed=7)),
    # 802.3an 10GBASE-T class: (2048, 384) dv=6 dc~32 high-rate regular
    # (the standard's RS-LDPC has the same degrees/size; its exact H loads
    # via load_alist). Native PEG keeps construction under a second.
    "highrate_2048_384": lambda: build_code(peg(2048, 384, 6, seed=8)),
    # DVB-S2 rate-1/2 size class (see load_named_qc for the QC structure)
    "dvbs2_like_64800_32400": lambda: load_named_qc(
        "dvbs2_like_64800_32400"
    ).to_code(),
    # REAL standard codes (codes/standards.py: exact tables, verified
    # against the reference's shipped matrices)
    "wifi_648_324": lambda: load_named_qc("wifi_648_324").to_code(),
    "wifi_1944_972": lambda: load_named_qc("wifi_1944_972").to_code(),
    "dvbs2_1_2": lambda: _standards_dvbs2(),
    "dvbs2_1_2_qc": lambda: load_named_qc("dvbs2_1_2_qc").to_code(),
    # 4376.282-class high-rate code: (4376, 282) dv=4, R≈0.9356 — the size/
    # degree class of the reference's 4376.282.4.9598 SM-NGDBF operating
    # point (its exact H loads via load_alist)
    "highrate_4376_282": lambda: build_code(peg(4376, 282, 4, seed=11)),
}


def _standards_dvbs2() -> Code:
    from .standards import dvbs2_rate12

    return dvbs2_rate12()
