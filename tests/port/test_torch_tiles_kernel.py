"""K3 (tile-table scan over whole rows) and K7 (band scan): the port's plain
versions (the wrappers' CPU path) against the reference's
``tiles_topk_pallas`` / ``band_topk_pallas`` in interpret mode, on the same
numpy inputs, in every score mode, at the shapes the card's tensor-core
kernel must take (D 48 and 100: a multiple of 16 and not; tile_q 16 and
48: whole and partial 32-query blocks); the shared bucketed-slot merge;
and chip_smoke.py's count of tensor-core instructions in SASS text. (The
CUDA kernel is held to the plain versions on the card by chip_smoke.py.)

Tolerances: int8 x int8 scores are exact integers, so values and ids are
equal outright. bf16 x int8 ('hybrid'), bf16 and f32 scores within 1e-5
absolute (f32 sums of the same products in another order; data scaled to
unit-order scores); ids equal except at near-ties (scores within 1e-5).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.ops.pallas_band import band_topk_pallas, tiles_topk_pallas
from cloudvectordb_tpu_torch.ops import band

TOL = 1e-5
#: the reference's int8 flag -> (query dtype, row dtype)
MODES = {"int8": (True, "int8", "int8"), "hybrid": ("hybrid", "bfloat16", "int8"),
         "bf16": (False, "bfloat16", "bfloat16"), "f32": (False, "float32", "float32")}
#: (D, tile_q): row depths a multiple of 16 and not, whole and partial query blocks
SHAPES = pytest.mark.parametrize("d,tile_q", [(48, 16), (48, 48), (100, 16), (100, 48)],
                                 ids=["d48-tq16", "d48-tq48", "d100-tq16", "d100-tq48"])


def _inputs(seed, mode, *, d=48, tile_n=256, tile_q=16, n_tiles=6, p=5):
    """Rows and queries (two query tiles) of the mode's types, a table whose
    last entry repeats its first, and n_valid inside the last tile."""
    int8, qt, rt = MODES[mode]
    rng = np.random.default_rng(seed)
    n = n_tiles * tile_n
    nq = 2 * tile_q

    def make(m, dt, scale):
        if dt == "int8":
            return rng.integers(-127, 128, size=(m, d), dtype=np.int8)
        x = (rng.normal(size=(m, d)) * scale).astype(np.float32)
        return x.astype(ml_dtypes.bfloat16) if dt == "bfloat16" else x

    rows = make(n, rt, 1 / np.sqrt(d))
    # unit-order scores: against int8 rows the queries carry 1/127
    queries = make(nq, qt, (1 / 127 if rt == "int8" else 1.0) / np.sqrt(d))
    table = rng.integers(0, n_tiles, size=(nq // tile_q, p)).astype(np.int32)
    table[:, -1] = table[:, 0]
    return dict(int8=int8, db=rows, q=queries, table=table, n_valid=n - tile_n // 3,
                tile_n=tile_n, tile_q=tile_q)


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def _assert_agree(mode, v_ref, i_ref, v, i):
    v_ref, i_ref = np.asarray(v_ref), np.asarray(i_ref)
    if mode == "int8":
        np.testing.assert_array_equal(v, v_ref)
        np.testing.assert_array_equal(i, i_ref)
        return
    np.testing.assert_allclose(v, v_ref, atol=TOL, rtol=0)
    same = i == i_ref
    assert np.all(np.abs(v - v_ref)[~same] <= TOL)
    assert same.mean() >= 0.99, same.mean()


@SHAPES
@pytest.mark.parametrize("l_buckets", [0, 64], ids=["R1", "R4"])
@pytest.mark.parametrize("mode", list(MODES))
def test_tiles_reference_matches_pallas_interpret(mode, l_buckets, d, tile_q):
    x = _inputs(1, mode, d=d, tile_q=tile_q)
    kw = dict(tile_n=x["tile_n"], tile_q=x["tile_q"], l_buckets=l_buckets,
              int8=x["int8"], n_valid=x["n_valid"])
    v_j, i_j = tiles_topk_pallas(jnp.asarray(x["db"]), jnp.asarray(x["q"]),
                                 jnp.asarray(x["table"]), 10, interpret=True, **kw)
    v, i = band.tiles_topk(_torch(x["db"]), _torch(x["q"]), torch.from_numpy(x["table"]),
                           10, **kw)
    _assert_agree(mode, v_j, i_j, v.numpy(), i.numpy())
    assert np.isfinite(v.numpy()).all()


@pytest.mark.parametrize("l_buckets,k", [(0, 10), (64, 10), (16, 24)],
                         ids=["R1", "R4", "R16_k_gt_L"])
@pytest.mark.parametrize("mode", list(MODES))
def test_tiles_top2_matches_pallas_interpret(mode, l_buckets, k):
    """K3's top2 (best two distinct rows a bucket, 2·L candidates) against
    the reference, every score mode; the table repeats an entry (the
    repeat must change nothing) and n_valid cuts the last tile. With k
    above L the second slots rank."""
    x = _inputs(6, mode, d=100, tile_q=48)
    x["table"][:, 2] = x["table"][:, 1]  # a second repeat, next to its first
    kw = dict(tile_n=x["tile_n"], tile_q=x["tile_q"], l_buckets=l_buckets,
              int8=x["int8"], n_valid=x["n_valid"], top2=True)
    v_j, i_j = tiles_topk_pallas(jnp.asarray(x["db"]), jnp.asarray(x["q"]),
                                 jnp.asarray(x["table"]), k, interpret=True, **kw)
    args = (_torch(x["db"]), _torch(x["q"]), torch.from_numpy(x["table"]), k)
    v, i = band.tiles_topk(*args, **kw)
    _assert_agree(mode, v_j, i_j, v.numpy(), i.numpy())
    assert np.isfinite(v.numpy()).all()
    for q in range(i.shape[0]):  # the two slots of a bucket hold distinct rows
        assert len(set(i[q].tolist())) == k
    if k > (l_buckets or x["tile_n"]):  # top-2's slots are a superset of top-1's
        top1 = band.tiles_topk(*args, **dict(kw, top2=False))[0].numpy()
        assert top1.shape[1] == l_buckets and (v.numpy()[:, :l_buckets] >= top1).all()


@SHAPES
@pytest.mark.parametrize("mode", list(MODES))
def test_band_reference_matches_pallas_interpret_clamped(mode, d, tile_q):
    """The second band starts at n_tiles - band_tiles: the clamp the index
    applies, so the band ends at the arena's last (partly valid) tile."""
    x = _inputs(2, mode, d=d, tile_q=tile_q)
    starts = np.array([1, 6 - 3], np.int32)
    kw = dict(tile_n=x["tile_n"], tile_q=x["tile_q"], int8=x["int8"],
              n_valid=x["n_valid"])
    v_j, i_j = band_topk_pallas(jnp.asarray(x["db"]), jnp.asarray(x["q"]),
                                jnp.asarray(starts), 10, band_tiles=3, interpret=True, **kw)
    v, i = band.band_topk(_torch(x["db"]), _torch(x["q"]), torch.from_numpy(starts), 10,
                          3, **kw)
    _assert_agree(mode, v_j, i_j, v.numpy(), i.numpy())
    assert (i.numpy() < x["n_valid"]).all()


def test_n_valid_defaults_to_the_padded_size():
    x = _inputs(3, "f32")
    args = (jnp.asarray(x["db"]), jnp.asarray(x["q"]), jnp.asarray(x["table"]), 7)
    v_j, i_j = tiles_topk_pallas(*args, tile_n=256, tile_q=16, interpret=True)
    v, i = band.tiles_topk(_torch(x["db"]), _torch(x["q"]), torch.from_numpy(x["table"]),
                           7, tile_n=256, tile_q=16)
    _assert_agree("f32", v_j, i_j, v.numpy(), i.numpy())


def test_wrappers_cpu_path_is_the_reference():
    x = _inputs(4, "hybrid")
    args = (_torch(x["db"]), _torch(x["q"]), torch.from_numpy(x["table"]), 10)
    kw = dict(tile_n=256, tile_q=16, int8="hybrid", n_valid=x["n_valid"])
    before = (band.tiles_topk.launches, band.band_topk.launches)
    for a, b in zip(band.tiles_topk(*args, **kw), band.tiles_topk_reference(*args, **kw)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    starts = torch.tensor([0, 2], dtype=torch.int32)
    bargs = (args[0], args[1], starts, 10, 4)
    for a, b in zip(band.band_topk(*bargs, **kw), band.band_topk_reference(*bargs, **kw)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (band.tiles_topk.launches, band.band_topk.launches) == before


def test_top2_and_wrong_score_modes_raise():
    """top2, which this test once refused, is held against the reference
    (int8: values and ids equal outright); wrong score modes still raise."""
    x = _inputs(5, "int8")
    args = (_torch(x["db"]), _torch(x["q"]), torch.from_numpy(x["table"]), 10)
    v_j, i_j = tiles_topk_pallas(jnp.asarray(x["db"]), jnp.asarray(x["q"]),
                                 jnp.asarray(x["table"]), 10, tile_n=256, tile_q=16,
                                 int8=True, top2=True, interpret=True)
    v, i = band.tiles_topk(*args, tile_n=256, tile_q=16, int8=True, top2=True)
    _assert_agree("int8", v_j, i_j, v.numpy(), i.numpy())
    with pytest.raises(TypeError):  # int8 queries are not the hybrid mode's
        band.tiles_topk(*args, tile_n=256, tile_q=16, int8="hybrid")
    with pytest.raises(TypeError):  # int8 rows need the int8 flag
        band.tiles_topk(*args, tile_n=256, tile_q=16, int8=False)


def test_bucket_merge_tie_order():
    """Within a step the smallest r wins a tie; across steps a strict '>'
    keeps the earlier step; slots start at (-inf, row 0)."""
    best_v, best_i = band._slots_init(1, 1, 2, torch.device("cpu"))
    s = torch.tensor([[[1.0, float("-inf"), 1.0, float("-inf")]]])  # tile_n 4, L 2
    best_v, best_i = band._bucket_merge(s, torch.tensor([8]), 2, best_v, best_i)
    assert best_v.tolist() == [[[1.0, float("-inf")]]]
    assert best_i.tolist() == [[[8, 0]]]  # r = 0 won the tie; slot 1 never filled
    s2 = torch.tensor([[[0.5, 2.0, 1.0, 2.0]]])
    best_v, best_i = band._bucket_merge(s2, torch.tensor([20]), 2, best_v, best_i)
    assert best_v.tolist() == [[[1.0, 2.0]]] and best_i.tolist() == [[[8, 21]]]


def test_sass_tensor_core_counts_on_canned_lines():
    """chip_smoke.py counts HMMA and IMMA (mma.sync) and HGMMA and IGMMA
    (wgmma) per kernel in ``cuobjdump --dump-sass`` text; FFMA, IMAD and a
    name that merely contains MMA do not count."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    sass = """
        Function : _Z3onev
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   IMMA.16832.S8.S8 R16, R20, R24, R16 ;
        /*0020*/                   FFMA R1, R2, R3, R1 ;
        /*0030*/                   IMMA.16832.S8.S8 R16, R20, R26, R16 ;
        Function : _Z3twov
        /*0000*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0010*/                   IGMMA.64x64x32.S8.S8 R0, gdesc[UR8], R0 ;
        /*0020*/                   IMAD R5, R6, R7, R5 ;
        /*0030*/                   CALL.REL.NOINC `(MMA_HELPER) ;
    """
    counts = chip_smoke.sass_tensor_core_counts(sass)
    assert counts == {"_Z3onev": ({"HMMA": 1, "IMMA": 2}, 4),
                      "_Z3twov": ({"HGMMA": 1, "IGMMA": 1}, 4)}


def _sass(functions: dict[str, list[str]]) -> str:
    """cuobjdump-style text: each mangled symbol with its instructions."""
    lines = []
    for sym, ops in functions.items():
        lines.append(f"        Function : {sym}")
        lines += [f"        /*{16 * n:04x}*/                   {op} ;" for n, op in enumerate(ops)]
    return "\n".join(lines)


_NARROW, _WIDE = "6TcCfgILi8ELi1ELi1ELi3ELi128EE", "6TcCfgILi2ELi4ELi2ELi4ELi256EE"


def _scan_functions(f32_op: str = "FFMA R1, R2, R3, R1") -> dict[str, list[str]]:
    """tiles_scan.cu's kernels as its SASS names them: 15 tensor-core
    instantiations (three sources x three pairs narrow, three int8 wide,
    K3's top-2 over the three pairs), 6 of the f32 body (three sources x f32
    and bf16 rows)."""
    op = {0: "IMMA.16832.S8.S8 R16, R20, R24, R16", 1: "HMMA.16816.F32.BF16 R4, R8, R12, R4",
          2: "HMMA.16816.F32.BF16 R4, R8, R12, R4"}
    tc = "_ZN12_GLOBAL__N_115tiles_tc_kernelILi{}ELi{}E{}Lb{}EEEvNS_6TcArgsE"
    fns = {}
    for src in range(3):
        for pair in range(3):
            fns[tc.format(src, pair, _NARROW, 0)] = ["LDSM.16.M88.4 R8, [R2]", op[pair]]
            if src == 1:
                fns[tc.format(src, pair, _NARROW, 1)] = ["LDSM.16.M88.4 R8, [R2]", op[pair]]
        fns[tc.format(src, 0, _WIDE, 0)] = [op[0]]
        for rt in ("f", "13__nv_bfloat16"):
            fns[f"_ZN12_GLOBAL__N_116tiles_f32_kernelILi{src}E{rt}EEvNS_7F32ArgsE"] = [
                "LDS.128 R4, [R2]", f32_op]
    fns["_ZN12_GLOBAL__N_117tiles_scan_kernelILi0EaaEEvPKT1_PKT0_PKiPKfPfPiiiiiii"] = [
        "IDP.4A.S8.S8 R1, R2, R3, R1"]
    return fns


def test_sass_checks_of_the_scan_refuse_tensor_cores_in_the_f32_body():
    """chip_smoke.py's scan_tensor_core_check passes tiles_scan.cu's kernels
    when every tensor-core instantiation runs its pair's instruction and the
    f32 body none; an HMMA (TF32 or bf16) in the f32 body fails it, as does a
    tensor-core instantiation without its instruction."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    chip_smoke.scan_tensor_core_check(chip_smoke.sass_tensor_core_counts(_sass(_scan_functions())))
    bad = _sass(_scan_functions(f32_op="HMMA.1684.F32.TF32 R4, R8, R12, R4"))
    with pytest.raises(AssertionError, match="f32 body"):
        chip_smoke.scan_tensor_core_check(chip_smoke.sass_tensor_core_counts(bad))
    fns = _scan_functions()
    fns[next(iter(fns))] = ["LDSM.16.M88.4 R8, [R2]", "IDP.4A.S8.S8 R1, R2, R3, R1"]
    with pytest.raises(AssertionError, match="ALL int8 narrow"):
        chip_smoke.scan_tensor_core_check(chip_smoke.sass_tensor_core_counts(_sass(fns)))
    fns = _scan_functions()  # a top-2 instantiation without its instruction
    fns[[k for k in fns if "ILi1ELi1E" in k and "Lb1E" in k][0]] = ["FFMA R1, R2, R3, R1"]
    with pytest.raises(AssertionError, match="TABLE hybrid narrow top2"):
        chip_smoke.scan_tensor_core_check(chip_smoke.sass_tensor_core_counts(_sass(fns)))


def test_sass_checks_count_k1s_kernels():
    """K1's 16 scan instantiations (int8 or 'precise' queries x mask x l2 x
    top-2) and its centroid-term prologue are found by their names in
    tiles_resid.cu's SASS and counted: IMMA in the int8 scans, HMMA in the
    'precise' ones and in the prologue; a missing one, or one without its
    instruction, fails resid_tensor_core_check."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    imma, hmma = "IMMA.16832.S8.S8 R16, R20, R24, R16", "HMMA.16816.F32.BF16 R4, R8, R12, R4"
    scan = ("_ZN12_GLOBAL__N_117resid_scan_kernelILi{}ELb{}ELb{}ELb{}EEEv6TcScan"
            "NS_5ResidIXT0_EXT1_EEE")
    prologue = "_ZN12_GLOBAL__N_121resid_centroid_kernelEPK13__nv_bfloat16S2_PKiPfxiiiii"
    bias = "_ZN12_GLOBAL__N_117resid_bias_kernelEPKaPKhPK13__nv_bfloat16Pfxiiif"

    def fns():
        out = {scan.format(p, m, l, t): [imma if p == 0 else hmma, "FADD R1, R2, R3"]
               for p in (0, 1) for m in (0, 1) for l in (0, 1) for t in (0, 1)}
        out[prologue] = [hmma, "FADD R1, R2, R3"]
        out[bias] = ["FFMA R1, R2, R3, R1"]
        return out

    counts = chip_smoke.sass_tensor_core_counts(_sass(fns()))
    assert sum(chip_smoke.kernel_name(k) == "resid_scan_kernel" for k in counts) == 16
    assert counts[scan.format(1, 1, 0, 1)] == ({"HMMA": 1}, 2)
    assert chip_smoke.resid_label(scan.format(1, 1, 0, 1)) == "scan precise mask top2"
    chip_smoke.resid_tensor_core_check(counts)
    for fault, match in (("prologue", "16 scan"), ("precise", "scan precise l2"),
                         ("missing", "15 scan")):
        f = fns()
        if fault == "prologue":
            f[prologue] = ["FFMA R1, R2, R3, R1"]
            match = "resid_centroid_kernel"
        elif fault == "precise":
            f[scan.format(1, 0, 1, 0)] = [imma]  # int8 instructions in a bf16 scan
        else:
            del f[scan.format(0, 1, 1, 1)]
        with pytest.raises(AssertionError, match=match):
            chip_smoke.resid_tensor_core_check(chip_smoke.sass_tensor_core_counts(_sass(f)))