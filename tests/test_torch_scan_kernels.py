"""What kernels L (``selective_scan``) and M (``wkv6``) decide on the host,
checked without a card: the shapes and dtypes they refuse (the same head
dims and state sizes as the CUDA sources build), the operands' 16-byte
alignment, the ctypes argument lists against the C entry points, and each
source's note naming its bound."""
import ctypes
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.build import aligned16  # noqa: E402
from repro_torch.kernels.scans import selective_scan as L  # noqa: E402
from repro_torch.kernels.scans import wkv6 as M  # noqa: E402

CSRC = Path(M.__file__).resolve().parent / "csrc"


def _wkv_ops(B=2, T=3, H=5, hd=64, dtype=torch.bfloat16, device="meta"):
    def t(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)
    f = torch.float32
    return (t(B, T, H, hd), t(B, T, H, hd), t(B, T, H, hd),
            t(B, T, H, hd, dt=f), t(H, hd, dt=f), t(B, H, hd, hd, dt=f))


def _ss_ops(B=2, T=3, di=128, ds=16, dtype=torch.bfloat16, device="meta"):
    def t(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)
    f = torch.float32
    return (t(B, T, di), t(B, T, di, dt=f), t(B, T, ds), t(B, T, ds),
            t(di, ds, dt=f), t(B, di, ds, dt=f))


@pytest.mark.parametrize("hd", [1, 2, 4, 12, 128])
def test_wkv6_refuses_head_dims_it_is_not_built_for(hd):
    with pytest.raises(ValueError, match="head_dim"):
        M.kernel_check(*_wkv_ops(hd=hd))


@pytest.mark.parametrize("case", ["f16", "mixed", "w_bf16", "u_f64"])
def test_wkv6_refuses_dtypes_it_does_not_take(case):
    r, k, v, w, u, S0 = _wkv_ops()
    if case == "f16":
        r, k, v = (x.to(torch.float16) for x in (r, k, v))
    elif case == "mixed":
        k = k.float()
    elif case == "w_bf16":
        w = w.bfloat16()
    else:
        u = u.double()
    with pytest.raises(ValueError, match="wkv6: .* must"):
        M.kernel_check(r, k, v, w, u, S0)


@pytest.mark.parametrize("case", ["ds4", "ds32", "odd_bf16", "f16", "dt_bf16",
                                  "rows"])
def test_selective_scan_refuses_what_it_does_not_take(case):
    kw = {"ds4": {"ds": 4}, "ds32": {"ds": 32}, "odd_bf16": {"di": 8191},
          "rows": {"B": L.MAX_ROWS + 1, "T": 1, "di": 2}}.get(case, {})
    xi, dt, Bc, Cc, A, h0 = _ss_ops(**kw)
    if case == "f16":
        xi, Bc, Cc = (x.to(torch.float16) for x in (xi, Bc, Cc))
    elif case == "dt_bf16":
        dt = dt.bfloat16()
    with pytest.raises(ValueError, match="selective_scan: "):
        L.kernel_check(xi, dt, Bc, Cc, A, h0)


def test_selective_scan_takes_an_odd_d_inner_in_f32():
    L.kernel_check(*_ss_ops(di=8191, dtype=torch.float32))


def _cases(source, function):
    """The ``case N:`` labels of ``function``'s switch in ``source``."""
    text = (CSRC / source).read_text()
    body = text[text.index(f"int {function}("):]
    body = body[:body.index("default:")]
    return tuple(int(n) for n in re.findall(r"case (\d+):", body))


def test_the_wrappers_take_what_the_sources_build():
    assert _cases("wkv6.cu", "launch_hd") == M.HEAD_DIMS
    assert _cases("selective_scan.cu", "launch_ds") == L.D_STATES
    for hd in M.HEAD_DIMS:
        M.kernel_check(*_wkv_ops(hd=hd, dtype=torch.float32))
    for ds in L.D_STATES:
        L.kernel_check(*_ss_ops(ds=ds))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_aligned16_copies_only_a_misaligned_operand(dtype):
    base = torch.arange(40, dtype=dtype)
    whole = aligned16(base)
    assert whole.data_ptr() == base.data_ptr()
    view = base[1:33]  # 2 or 4 bytes past an aligned start
    got = aligned16(view)
    assert got.data_ptr() % 16 == 0 and got.data_ptr() != view.data_ptr()
    assert torch.equal(got, view)
    strided = base.reshape(8, 5)[:, :4]
    assert aligned16(strided).is_contiguous()
    assert torch.equal(aligned16(strided), strided)


def _entry_argtypes(source, symbol):
    text = (CSRC / source).read_text()
    m = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*\{{', text, re.S)
    assert m, symbol
    types = []
    for arg in m.group(1).split(","):
        arg = " ".join(arg.split())
        types.append(ctypes.c_void_p if "*" in arg else ctypes.c_int)
        assert "*" in arg or arg.startswith("int "), arg
    return types


@pytest.mark.parametrize("kernel", [M.WKV6_KERNEL, L.SELECTIVE_SCAN_KERNEL],
                         ids=["wkv6", "selective_scan"])
def test_ctypes_argument_lists_match_the_entry_points(kernel):
    assert kernel.argtypes == _entry_argtypes(kernel.source.name,
                                              kernel.symbol)


@pytest.mark.parametrize("source,words", [
    ("wkv6.cu", ("issue floor of 0.562 ms", "rounded on its own", "__fadd_rn",
                 "cp.async", "Bound on this card")),
    ("selective_scan.cu", ("issue floor of 0.45 ms", "special function units",
                           "0.51 ms", "cp.async", "Bound on this card",
                           "rounded on its own",
                           "library's"))])
def test_each_source_note_names_its_bound(source, words):
    text = (CSRC / source).read_text()
    note = text[:text.index("#include")]
    for w in words:
        assert w in " ".join(note.replace("//", " ").split()), w
    assert "use_fast_math" not in "".join(
        ln for ln in text.splitlines() if not ln.lstrip().startswith("//"))
