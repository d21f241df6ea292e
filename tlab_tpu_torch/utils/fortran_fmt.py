"""Fortran-style E-format floats for log parity with the reference."""
from __future__ import annotations


def fort_e(x: float, digits: int) -> str:
    """Fortran Ew.d style: 0.dddE+ee with mantissa in [0.1, 1)."""
    if x != x:                     # NaN
        return "NaN"
    s = "-" if x < 0 else ""
    a = abs(x)
    if a == float("inf"):
        return f"{s}Infinity"
    if a == 0.0:
        return f"{s}0." + "0" * digits + "E+00"
    import math
    exp = int(math.floor(math.log10(a))) + 1
    mant = a / 10.0 ** exp
    mant = round(mant, digits)
    if mant >= 1.0:
        mant /= 10.0
        exp += 1
    mant_str = f"{mant:.{digits}f}"[1:]        # strip leading 0
    return f"{s}0{mant_str}E{exp:+03d}"
