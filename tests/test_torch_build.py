"""The C entry points of the CUDA kernels against their ctypes bindings.

``build.ENTRY_ARGS`` gives ctypes the argument types of every entry in
``src/repro_torch/kernels/csrc/*.cu``; a signature that changes on one side
only would pass a pointer as an int, or shift every later argument, and
show only on the card.  These tests read the prototypes of every
``extern "C"`` function from the sources and hold the bindings to them,
with no compiler and no card.
"""
import ctypes
import re

import pytest

from repro_torch.kernels import build

_BLOCK = re.compile(r'extern "C" \{(.*?)\}\s*//\s*extern "C"', re.S)
_FUNC = re.compile(r"^\s*(?:int|const char\*)\s+(\w+)\(([^)]*)\)\s*\{", re.M)
_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}


def _kind(arg: str) -> str:
    """'pointer', 'int' or 'float' for one C parameter declaration."""
    if "*" in arg:
        return "pointer"
    ctype = arg.split()[0]
    assert ctype in ("int", "float"), f"unexpected parameter type in {arg!r}"
    return ctype


def _prototypes() -> dict:
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        for block in _BLOCK.findall(src.read_text()):
            for name, args in _FUNC.findall(block):
                assert name not in found, f"{name} defined twice"
                found[name] = [_kind(a) for a in args.split(",") if a.strip()]
    return found


def _bound() -> dict:
    bound = dict(build.ENTRY_ARGS, hyft_error_string=build.ERROR_ARGS)
    return {name: [_KINDS[t] for t in types] for name, types in bound.items()}


def test_every_entry_point_is_bound():
    """Every extern "C" function of the sources has a binding, and every
    binding names a function of the sources."""
    protos = _prototypes()
    assert len(protos) >= 10
    assert set(protos) == set(_bound())


@pytest.mark.parametrize("name", sorted(build.ENTRY_ARGS) + ["hyft_error_string"])
def test_binding_matches_the_prototype(name):
    """The binding of ``name`` has the arity and the kinds (pointer, int,
    float) of the C prototype, in order."""
    assert _bound()[name] == _prototypes()[name]


def test_the_prototype_reader_sees_a_changed_signature():
    """The reader is what the check rests on: dq's prototype ends in the
    stream pointer and carries ``skip`` as an int after ``causal``."""
    src = (build.CSRC / "hyft_flash.cu").read_text()
    proto = re.search(r"int hyft_flash_bwd_dq\(([^)]*)\)", src).group(1)
    names = [a.split()[-1].lstrip("*") for a in proto.split(",")]
    assert names[names.index("causal") + 1] == "skip"
    assert _prototypes()["hyft_flash_bwd_dq"][-1] == "pointer"
    changed = proto.replace("int skip,", "")
    assert [_kind(a) for a in changed.split(",")] != _bound()["hyft_flash_bwd_dq"]


def test_softmax_bwd_prototype_takes_round_and_out_types():
    """The backward's entry rounds to one type and stores another: its
    prototype carries ``round_type`` and ``out_type`` after ``in_type``, and
    the binding has the int for each."""
    src = (build.CSRC / "hyft_softmax.cu").read_text()
    proto = re.search(r"int hyft_softmax_bwd\(([^)]*)\)", src).group(1)
    names = [a.split()[-1].lstrip("*") for a in proto.split(",")]
    at = names.index("in_type")
    assert names[at:at + 3] == ["in_type", "round_type", "out_type"]
    assert _bound()["hyft_softmax_bwd"] == _prototypes()["hyft_softmax_bwd"]
    assert _bound()["hyft_softmax_bwd"].count("int") == 7
