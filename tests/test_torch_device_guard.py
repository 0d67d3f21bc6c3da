"""Every kernel launch of the port runs on its tensors' device: each call
into a built library (``_build.lib(...)``) in cometbft_tpu_torch/ sits
inside a ``with torch.cuda.device(...)`` block, since the C entry points
launch on the calling thread's current device with only the stream passed
in; and every ``record`` of a completion event names its stream, since an
Event recorded without one lands on the current device's stream.  Read
from the source (an AST walk), so it holds where no card or only one
card exists; a planted file without the guard must fail."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "cometbft_tpu_torch").rglob("*.py"))


def _is_device_guard(item: ast.withitem) -> bool:
    f = item.context_expr.func if isinstance(item.context_expr, ast.Call) else None
    return (isinstance(f, ast.Attribute) and f.attr == "device" and isinstance(f.value, ast.Attribute)
            and f.value.attr == "cuda" and isinstance(f.value.value, ast.Name) and f.value.value.id == "torch")


def _is_lib_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "lib"
            and isinstance(node.func.value, ast.Name) and node.func.value.id == "_build")


def faults(path: pathlib.Path) -> list[str]:
    """Each unguarded library call and each stream-less record(), by line."""
    out = []

    def walk(node: ast.AST, guarded: bool) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(_is_device_guard(i) for i in node.items):
            guarded = True
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            guarded = False  # a function body runs wherever it is called from
        if _is_lib_call(node) and not guarded:
            out.append(f"{path.name}:{node.lineno}: _build.lib(...) outside torch.cuda.device(...)")
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "record"
                and not node.args and not node.keywords):
            out.append(f"{path.name}:{node.lineno}: record() without a stream")
        for child in ast.iter_child_nodes(node):
            walk(child, guarded)

    walk(ast.parse(path.read_text(), filename=str(path)), False)
    return out


def test_port_has_launches_to_check():
    calls = sum(1 for p in PORT_FILES for n in ast.walk(ast.parse(p.read_text())) if _is_lib_call(n))
    assert calls >= 16  # K1-K15 and K14's finishing stage


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_launches_and_events_name_their_device(path):
    assert faults(path) == []


def test_scanner_catches_an_unguarded_launch(tmp_path):
    f = tmp_path / "planted.py"
    f.write_text(
        "import torch\n"
        "from cometbft_tpu_torch import _build\n"
        "def launch(x):\n"
        "    with torch.cuda.device(x.device):\n"
        "        ok = _build.lib('merkle').k9_merkle_gather(x.data_ptr())\n"
        "    bad = _build.lib('merkle').k7_sha256_blocks(x.data_ptr())\n"
        "    with torch.cuda.device(x.device):\n"
        "        def later():\n"
        "            return _build.lib('bls').k13_bls_validate()\n"
        "    done = torch.cuda.Event()\n"
        "    done.record()\n"
        "    done.record(torch.cuda.current_stream(x.device))\n"
    )
    assert [line.split(": ", 1)[0] for line in faults(f)] == ["planted.py:6", "planted.py:9", "planted.py:11"]
