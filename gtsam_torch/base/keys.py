"""Keys and symbols.

A copy of gtsam_tpu/base/keys.py (pure Python).  A Key is a plain uint64: 8-bit char tag + 56-bit index, matching the reference
gtsam/inference/Symbol.h:39-75.  Keys are host-side metadata (graph structure);
on device, variables are dense row indices per manifold type.
"""


def symbol(c: str, j: int) -> int:
    """Key for, e.g., symbol('x', 3)."""
    return (ord(c) << 56) | j


def symbol_chr(key: int) -> str:
    c = (key >> 56) & 0xFF
    return chr(c) if c else ""


def symbol_index(key: int) -> int:
    return key & ((1 << 56) - 1)


def format_key(key: int) -> str:
    c = symbol_chr(key)
    return f"{c}{symbol_index(key)}" if c else str(key)


def labeled_symbol(c: str, label: str, j: int) -> int:
    """Multi-robot keys: 8-bit type char + 8-bit label + 48-bit index
    (gtsam/inference/LabeledSymbol.h)."""
    return (ord(c) << 56) | (ord(label) << 48) | j


def labeled_symbol_chr(key: int) -> str:
    return chr((key >> 56) & 0xFF)


def labeled_symbol_label(key: int) -> str:
    return chr((key >> 48) & 0xFF)


def labeled_symbol_index(key: int) -> int:
    return key & ((1 << 48) - 1)


class _Shorthand:
    """X = Shorthand('x'); X(3) == symbol('x', 3) — python/gtsam/symbol_shorthand.py analog."""

    def __init__(self, c: str):
        self._c = c

    def __call__(self, j: int) -> int:
        return symbol(self._c, j)


def shorthand(c: str) -> _Shorthand:
    return _Shorthand(c)
