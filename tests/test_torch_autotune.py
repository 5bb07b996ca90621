"""The port's tile autotuner (``repro_torch.kernels.autotune``) against the JAX package's.

The JAX package tunes ``(tm, tn, tk)``; the port tunes ``(engine, pack)``
(the GEMM kernels' tile engine and the output blocks a TileRows tile packs).
The two share the key string, the cache file's schema and states, the
memo, the round trip and the choice of a winner from timed candidates, and
are held to each other on the same inputs here; the port's own rules
(the candidates, the rule as a pair, the validation of a stale entry, the
wrappers' dispatch and the dispatch span) are held to the kernels' rule.
Every test runs against a cache file of its own (``tile_cache``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import repro.kernels.autotune as ref  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import block_spmm as bsp  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def tile_cache(tmp_path, monkeypatch):
    """Both packages' caches point into the test's own directory."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "reference.json"))
    at.clear_memo()
    ref.clear_memo()
    yield str(path)
    at.clear_memo()
    ref.clear_memo()


def _stack(shape, offset=0, dtype=torch.float32):
    """A contiguous CPU stack whose data starts ``offset`` elements past an aligned base."""
    n = int(np.prod(shape))
    base = torch.empty(n + 16, dtype=dtype)
    lead = (-base.data_ptr() % 16) // base.element_size() + offset
    return base[lead:lead + n].view(shape)


# --- the key, the file, the round trip: the JAX package's contracts ---------


@pytest.mark.parametrize("bm,bk,bn", [(8, 8, 8), (8, 4096, 1536), (24, 10, 200), (64, 64, 64),
                                      (128, 128, 128), (130, 70, 66)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("platform", ["cpu", H100])
def test_tile_key_equals_the_reference(bm, bk, bn, dtype, platform):
    want = ref.tile_key(platform, bm, bk, bn, jnp.dtype(dtype))
    assert want == f"{platform}|{bm}x{bk}x{bn}|{dtype}"
    for d in (getattr(torch, dtype), dtype, np.dtype("float32") if dtype == "float32" else dtype):
        assert at.tile_key(platform, bm, bk, bn, d) == want


def test_cache_paths_are_the_packages_own(monkeypatch):
    """The port's file is not the reference's: its loader keeps only entries of three ints."""
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    monkeypatch.setenv("HOME", "/home/someone")
    assert at.default_cache_path() == "/home/someone/.cache/repro_torch/autotune.json"
    assert ref.default_cache_path() == "/home/someone/.cache/repro/autotune.json"


def _file(state: str, package: str) -> str | None:
    """The text of a cache file in ``state`` for ``package`` (``None``: no file)."""
    entry = {"port": ["tilerows", 4], "ref": [8, 8, 8]}[package]
    other = {"port": [8, 8, 8], "ref": ["tilerows", 4]}[package]
    return {
        "missing": None,
        "not_json": "{not json",
        "binary": "\udcff\x00",
        "not_a_dict": "[1, 2, 3]",
        "version_999": json.dumps({"version": 999, "entries": {"k": entry}}),
        "entries_not_a_dict": json.dumps({"version": 1, "entries": [entry]}),
        "malformed_entries": json.dumps({"version": 1, "entries": {
            "a": "tilerows", "b": [1, 2], "c": {"x": 1}, "d": [["tilerows"], 4], "e": None}}),
        "the_other_packages_entries": json.dumps({"version": 1, "entries": {"k": other}}),
        "valid": json.dumps({"version": 1, "entries": {"k": entry, "bad": [None, None]}}),
    }[state]


@pytest.mark.parametrize("state", ["missing", "not_json", "binary", "not_a_dict", "version_999",
                                   "entries_not_a_dict", "malformed_entries",
                                   "the_other_packages_entries", "valid"])
def test_loaders_read_the_same_file_states(tmp_path, state):
    """Both loaders read each file state as empty, or keep the same keys."""
    kept = {}
    for package, mod in (("port", at), ("ref", ref)):
        path = tmp_path / f"{package}.json"
        text = _file(state, package)
        if text is not None:
            path.write_bytes(text.encode("utf-8", "surrogateescape"))
        mod.clear_memo()
        kept[package] = set(mod.load_tile_cache(str(path)))
    assert kept["port"] == kept["ref"] == ({"k"} if state == "valid" else set())
    if state == "valid":
        assert at.load_tile_cache(str(tmp_path / "port.json")) == {"k": ("tilerows", 4)}


# candidates of each package for one block shape (16 x 16 x 16), index for index
PORT_CANDS = [("tile64", 1), ("tilerows", 1), ("tilerows", 2), ("tilerows", 4)]
REF_CANDS = [(16, 16, 16), (8, 8, 8), (4, 4, 4), (2, 2, 2)]


@pytest.mark.parametrize("times,raising", [((3.0, 2.0, 1.0, 4.0), 3), ((1.0, 2.0, 3.0, 4.0), 2),
                                           ((5.0, 4.0, 3.0, 0.5), 0), ((2.0, 2.0, 2.0, 2.0), 1)])
def test_autotune_tiles_picks_the_same_winner_as_the_reference(monkeypatch, tile_cache, tmp_path,
                                                               times, raising):
    """With each module's ``time_call`` patched to one table of times and one
    candidate refused, both tuners pick the same candidate, record the same
    refused one, persist the winner and pick it back up."""
    picks = {}
    for mod, cands, path in ((at, PORT_CANDS, tile_cache), (ref, REF_CANDS, str(tmp_path / "r.json"))):
        monkeypatch.setattr(mod, "time_call", lambda fn, reps: times[fn()])

        def bench(*tiles, cands=cands):
            i = cands.index(tuple(tiles))
            if i == raising:
                raise RuntimeError("tiling refused")
            return lambda: i

        best, rows = mod.autotune_tiles(16, 16, 16, "float32", bench=bench, candidates=cands,
                                        reps=1, platform="cpu", path=path)
        assert [tuple(r["tiles"]) for r in rows] == cands
        mod.clear_memo()
        assert tuple(mod.pick_tiles(16, 16, 16, "float32", platform="cpu", path=path)) == tuple(best)
        picks[mod.__name__] = (cands.index(tuple(best)), [i for i, r in enumerate(rows) if r["us"] is None],
                               [r["us"] for r in rows])
    assert picks[at.__name__] == picks[ref.__name__]
    assert picks[at.__name__][1] == [raising]


def test_autotune_tiles_with_every_candidate_refused_takes_the_rule_and_saves_nothing(tile_cache):
    def bench(engine, pack):
        raise RuntimeError("refused")

    best, rows = at.autotune_tiles(8, 8, 8, bench=bench, platform="cpu", path=tile_cache)
    assert best == at.heuristic_tiles(8, 8, 8) == ("tilerows", 8)
    assert all(r["us"] is None and r["error"] == "refused" for r in rows)
    assert at.load_tile_cache(tile_cache) == {}


def test_autotune_tiles_without_a_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("on a card the default bench times the kernels")
    with pytest.raises(RuntimeError, match="needs a card"):
        at.autotune_tiles(8, 8, 8)


def test_time_call_warms_up_once_then_means_over_reps():
    calls = []
    t = at.time_call(lambda: calls.append(1), reps=4)
    assert len(calls) == 5 and t >= 0.0


def test_time_call_means_the_seconds_a_bench_times_itself():
    """A callable that returns its own (device) seconds is timed by them,
    not by the wall clock; the warm-up's reading is dropped."""
    readings = iter([9.0, 1.0, 2.0, 6.0])
    assert at.time_call(lambda: next(readings), reps=3) == 3.0


@pytest.mark.parametrize("persist,saved", [(None, False), (False, False), (True, True)])
def test_the_default_benchs_winner_is_saved_only_when_asked(monkeypatch, tile_cache, persist,
                                                            saved):
    """The default bench's random list is no path's traffic: its winner is
    returned and reported, and saved only with ``persist=True``; a caller's
    bench saves by default."""
    times = {("tile64", 1): 1.0, ("tilerows", 1): 2.0, ("tilerows", 2): 3.0}
    bench = lambda *tiles: lambda: times[tiles]  # noqa: E731
    monkeypatch.setattr(at, "_default_bench", lambda *a: bench)
    best, rows = at.autotune_tiles(32, 32, 32, "float32", reps=1, platform="cpu", path=tile_cache,
                                   persist=persist)
    assert best == ("tile64", 1) and [r["us"] for r in rows] == [1e6, 2e6, 3e6]
    key = at.tile_key("cpu", 32, 32, 32, "float32")
    assert (key in at.load_tile_cache(tile_cache)) == saved
    at.clear_memo()
    assert at.pick_tiles(32, 32, 32, platform="cpu", path=tile_cache) == \
        (("tile64", 1) if saved else at.heuristic_tiles(32, 32, 32))
    best, _ = at.autotune_tiles(32, 32, 32, "float32", bench=bench, reps=1, platform="cpu",
                                path=tile_cache)
    assert at.load_tile_cache(tile_cache)[key] == best == ("tile64", 1)


# --- the JAX package's own cases (tests/test_fused_leaf.py), in the port's terms


def test_autotune_roundtrip_and_pick(tile_cache):
    key = at.tile_key("cpu", 32, 32, 32, "float32")
    assert at.pick_tiles(32, 32, 32, "float32", platform="cpu", path=tile_cache) == \
        at.heuristic_tiles(32, 32, 32) == ("tilerows", 2)
    at.save_tile_entry(key, ("tile64", 1), path=tile_cache)
    assert at.pick_tiles(32, 32, 32, "float32", platform="cpu", path=tile_cache) == ("tile64", 1)
    assert at.pick_tiles(32, 32, 32, "float32", platform=H100, path=tile_cache) == ("tilerows", 2)
    # other dtype / shape still miss
    assert at.pick_tiles(32, 32, 32, "bfloat16", platform="cpu", path=tile_cache) == \
        at.heuristic_tiles(32, 32, 32)
    assert at.pick_tiles(64, 32, 32, "float32", platform="cpu", path=tile_cache) == \
        at.heuristic_tiles(64, 32, 32)
    # the default path is the environment's
    assert at.pick_tiles(32, 32, 32, torch.float32, platform="cpu") == ("tile64", 1)
    on_disk = json.loads(open(tile_cache).read())
    assert on_disk == {"version": 1, "entries": {key: ["tile64", 1]}}


def test_autotune_corrupt_file_falls_back(tile_cache):
    with open(tile_cache, "w") as fh:
        fh.write("{not json")
    assert at.load_tile_cache(tile_cache) == {}
    assert at.pick_tiles(32, 32, 32, platform="cpu", path=tile_cache) == at.heuristic_tiles(32, 32, 32)
    # wrong schema version also reads as empty
    with open(tile_cache, "w") as fh:
        json.dump({"version": 999, "entries": {"x": ["tile64", 1]}}, fh)
    at.clear_memo()
    assert at.load_tile_cache(tile_cache) == {}
    # a save over a corrupt file starts a fresh one
    at.save_tile_entry("x", ("tile64", 1), path=tile_cache)
    assert at.load_tile_cache(tile_cache) == {"x": ("tile64", 1)}


@pytest.mark.parametrize("bs,entry,offset", [
    (8, ("tile128", 1), 0),      # an engine that does not take the shape
    (96, ("tilerows", 1), 0),    # TileRows takes at most 64 rows
    (8, ("tilerows", 9), 0),     # a pack above rows_pack(8, 8)
    (32, ("tilerows", 0), 0),    # a pack below 1
    (128, ("tile128", 2), 0),    # Tile128 packs one block
    (64, ("tile64", 2), 0),      # Tile64 packs one block
    (128, ("tile128", 1), 1),    # Tile128 on a stack off a 16-byte boundary
])
def test_autotune_stale_entry_ignored(tile_cache, bs, entry, offset):
    at.save_tile_entry(at.tile_key("cpu", bs, bs, bs, "float32"), entry, path=tile_cache)
    stacks = (_stack((2, bs, bs), offset), _stack((2, bs, bs)))
    assert at.pick_tiles(bs, bs, bs, "float32", platform="cpu", path=tile_cache, tensors=stacks) == \
        at.heuristic_tiles(bs, bs, bs, stacks)
    if offset:  # the same entry on aligned stacks is taken
        aligned = (_stack((2, bs, bs)), _stack((2, bs, bs)))
        assert at.pick_tiles(bs, bs, bs, "float32", platform="cpu", path=tile_cache,
                             tensors=aligned) == entry


def test_save_refuses_what_is_not_a_pair(tile_cache):
    for bad in (("tile32", 1), ("tilerows", 1.0), (8, 8, 8), ("tilerows",)):
        with pytest.raises(ValueError):
            at.save_tile_entry("k", bad, path=tile_cache)


def test_memo_stats_the_file_once_an_interval_and_parses_it_when_its_mtime_moves(
        tile_cache, monkeypatch):
    import os

    at.save_tile_entry("k", ("tile64", 1), path=tile_cache)
    assert at.load_tile_cache(tile_cache) == {"k": ("tile64", 1)}
    stats, reads = [], []
    real_stat, real_load = os.path.getmtime, json.load
    monkeypatch.setattr(os.path, "getmtime", lambda p: stats.append(1) or real_stat(p))
    monkeypatch.setattr(json, "load", lambda fh: reads.append(1) or real_load(fh))
    for _ in range(3):  # within the interval: no stat, no parse
        assert at.load_tile_cache(tile_cache) == {"k": ("tile64", 1)}
    assert stats == [] and reads == []
    with open(tile_cache, "w") as fh:  # another process's write
        json.dump({"version": 1, "entries": {"k": ["tilerows", 2]}}, fh)
    st = os.stat(tile_cache)
    os.utime(tile_cache, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert at.load_tile_cache(tile_cache) == {"k": ("tile64", 1)}  # not seen yet
    monkeypatch.setattr(at, "STAT_INTERVAL_S", 0.0)  # the interval has passed
    assert at.load_tile_cache(tile_cache) == {"k": ("tilerows", 2)}
    assert at.load_tile_cache(tile_cache) == {"k": ("tilerows", 2)}
    assert len(stats) == 2 and reads == [1]  # a stat each, one parse: the mtime moved once
    # a missing file is remembered too, and this process's own save is seen at once
    monkeypatch.setattr(at, "STAT_INTERVAL_S", 1e9)
    other = tile_cache + ".other"
    assert at.load_tile_cache(other) == {} and at.load_tile_cache(other) == {}
    assert len(stats) == 3
    at.save_tile_entry("j", ("tile64", 1), path=other)
    assert at.load_tile_cache(other) == {"j": ("tile64", 1)}


# --- the port's tiling: candidates, the rule as a pair, packed steps ---------


@pytest.mark.parametrize("bs", [8, 16, 24, 32, 40, 48, 64, 96, 128, 130, 256])
def test_candidate_tiles(bs):
    cands = at.candidate_tiles(bs, bs, bs)
    full = bsp.rows_pack(bs, bs)
    want = [("tile64", 1)]
    if bs <= 64:
        want += [("tilerows", p) for p in (1, 2, 4, 8, 16) if p < full] + [("tilerows", full)]
    if bs % 128 == 0:
        want += [("tile128", 1)]
    assert cands == want
    assert at.heuristic_tiles(bs, bs, bs) in cands
    assert all(at.tiles_take(c, bs, bs, bs) for c in cands)
    packs = {8: [1, 2, 4, 8], 16: [1, 2, 4], 24: [1, 2], 32: [1, 2], 40: [1], 48: [1], 64: [1]}
    assert [p for e, p in cands if e == "tilerows"] == packs.get(bs, [])


def test_candidate_tiles_of_the_grouped_gemm_and_a_ragged_pack():
    assert at.candidate_tiles(8, 4096, 1536) == [("tile64", 1)] + [("tilerows", p) for p in (1, 2, 4, 8, 16)]
    # rows_pack(24, 200) is 5: the powers of two below it, then 5 (the rule's)
    assert at.candidate_tiles(24, 24, 200) == [("tile64", 1)] + [("tilerows", p) for p in (1, 2, 4, 5)]
    base = _stack((2, 128, 128), 1)
    assert at.candidate_tiles(128, 128, 128, (base, base)) == [("tile64", 1)]


@pytest.mark.parametrize("bm,bk,bn", [(64, 64, 64), (107, 448, 128), (128, 128, 128),
                                      (150, 40, 200), (256, 64, 64), (300, 64, 64)])
def test_candidate_tiles_at_a_bf16_tiletc_shape_is_tiletc_only(bm, bk, bn):
    """Where TileTC takes bf16 stores its pair is the only candidate (an FFMA
    engine rounds in another order); the same shape in fp32 offers the FFMA
    engines and never TileTC, and bf16 off a 16-byte boundary falls back to them."""
    bf = (_stack((1, bm, bk), 0, torch.bfloat16), _stack((1, bk, bn), 0, torch.bfloat16))
    f32 = (_stack((1, bm, bk)), _stack((1, bk, bn)))
    assert at.candidate_tiles(bm, bk, bn, bf) == [("tiletc", 1)] == [at.heuristic_tiles(bm, bk, bn, bf)]
    assert at.tiles_take(("tiletc", 1), bm, bk, bn, bf)
    cands = at.candidate_tiles(bm, bk, bn, f32)
    assert cands and all(e != "tiletc" for e, _ in cands) and at.heuristic_tiles(bm, bk, bn, f32) in cands
    assert cands == at.candidate_tiles(bm, bk, bn)  # no stacks: the fp32 rule
    odd = (_stack((1, bm, bk), 1, torch.bfloat16), bf[1])
    assert all(e != "tiletc" for e, _ in at.candidate_tiles(bm, bk, bn, odd))


@pytest.mark.parametrize("entry", [("tile64", 1), ("tile128", 1), ("tilerows", 1)])
def test_a_cached_ffma_pair_at_a_tiletc_shape_is_stale(tile_cache, entry):
    """A bf16 entry of an FFMA pair where TileTC takes the shape falls to the
    rule (TileTC), though a forced ``engine=`` still takes it; a TileTC entry
    under the fp32 key is stale too; where TileTC does not take the stacks
    (off a 16-byte boundary) the FFMA entry stands where its engine takes the shape."""
    bm = 64 if entry[0] == "tilerows" else 128
    bf = (_stack((2, bm, bm), 0, torch.bfloat16), _stack((2, bm, bm), 0, torch.bfloat16))
    at.save_tile_entry(at.tile_key("cpu", bm, bm, bm, "bfloat16"), entry, path=tile_cache)
    assert at.pick_tiles(bm, bm, bm, "bfloat16", platform="cpu", path=tile_cache, tensors=bf) == \
        ("tiletc", 1)
    assert not at.tiles_take(entry, bm, bm, bm, bf)
    assert bsp.launch_tiles(entry[0], None, bm, bm, bm, torch.bfloat16, bf, torch.device("cpu")) == entry
    odd = (_stack((2, bm, bm), 1, torch.bfloat16), bf[1])
    want = entry if entry[0] != "tile128" else ("tile64", 1)
    assert at.pick_tiles(bm, bm, bm, "bfloat16", platform="cpu", path=tile_cache, tensors=odd) == want
    f32 = (_stack((2, bm, bm)), _stack((2, bm, bm)))
    at.save_tile_entry(at.tile_key("cpu", bm, bm, bm, "float32"), ("tiletc", 1), path=tile_cache)
    assert at.pick_tiles(bm, bm, bm, "float32", platform="cpu", path=tile_cache, tensors=f32) == \
        at.heuristic_tiles(bm, bm, bm, f32) != ("tiletc", 1)


def test_engine_id_and_pack_id_refuse_tiletc_on_fp32():
    f32 = (_stack((2, 128, 128)), _stack((2, 128, 128)))
    bf = tuple(t.to(torch.bfloat16) for t in f32)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="tiletc"):
        bsp.engine_id("tiletc", 128, 128, 128, f32)
    with pytest.raises(ValueError, match="tiletc"):
        bsp.launch_tiles("tiletc", None, 128, 128, 128, torch.float32, f32, cpu)
    assert bsp.engine_id("tiletc", 128, 128, 128, bf) == bsp.ENGINES["tiletc"] == 4
    assert bsp.full_pack("tiletc", 128, 128) == 1
    assert [bsp.pack_id("tiletc", p, 128, 128) for p in (None, 1)] == [0, 1]
    for pack in (0, 2):
        with pytest.raises(ValueError, match="tiletc"):
            bsp.pack_id("tiletc", pack, 128, 128)
    assert bsp.launch_tiles("tiletc", None, 128, 128, 128, torch.bfloat16, bf, cpu) == ("tiletc", 1)
    assert not at.tiles_take(("tiletc", 1), 128, 128, 128, f32)


def test_heuristic_tiles_is_the_kernels_rule_over_a_grid():
    for bm in (1, 7, 8, 9, 16, 24, 40, 63, 64, 65, 96, 128, 130, 256):
        for bk in (8, 10, 128):
            for bn in (8, 33, 64, 65, 128, 200, 256):
                for offset in (0, 1):
                    stacks = (_stack((2, bm, bk), offset), _stack((2, bk, bn)))
                    engine = bsp.tile_engine(bm, bk, bn, stacks)
                    pack = bsp.rows_pack(bm, bn) if engine == "tilerows" else 1
                    assert at.heuristic_tiles(bm, bk, bn, stacks) == (engine, pack)
                    assert at.tiles_take((engine, pack), bm, bk, bn, stacks)
                    assert not at.tiles_take((engine, pack + 1), bm, bk, bn, stacks)


@pytest.mark.parametrize("bs", [8, 24, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_packed_steps_keep_each_blocks_task_order_at_every_pack(bs, seed):
    """TileRows' walk at every pack the tuner may pick: each block's tasks
    once each, in ascending order; a step holds blocks of one tile only and
    one B operand; the same steps' sums equal the plain version."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    nout, T, nb = 37, 300, 12
    c = np.sort(rng.integers(0, nout, T))
    b = rng.integers(0, nb, T)
    a = rng.integers(0, nb, T)
    run_ptr = bsp.task_runs(c, nout)
    A = torch.randn(nb, bs, bs, generator=torch.Generator().manual_seed(seed))
    want = bsp.block_spmm_ref(A, A, *ops.task_arrays(a, b, c, nout, "cpu"), nout)
    for _, pack in at.candidate_tiles(bs, bs, bs):
        steps = bsp.packed_steps(run_ptr, b, pack)
        seen = {blk: [] for blk in range(nout)}
        got = torch.zeros(nout, bs, bs)
        for g, step in steps:
            assert all(blk // pack == g for blk, _ in step)
            assert len({int(b[t]) for _, t in step}) == 1
            for blk, t in step:
                seen[blk].append(t)
                got[blk] += A[a[t]] @ A[b[t]]
        for blk in range(nout):
            assert seen[blk] == list(range(run_ptr[blk], run_ptr[blk + 1]))
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# --- dispatch: the wrappers' pick and the dispatch span ----------------------


def test_launch_tiles_reads_the_cache_and_checks_forced_pairs(tile_cache):
    cpu = torch.device("cpu")
    stacks = (_stack((3, 8, 8)), _stack((3, 8, 8)))
    pick = lambda *a: bsp.launch_tiles(*a, 8, 8, 8, torch.float32, stacks, cpu)  # noqa: E731
    assert pick(None, None) == ("tilerows", 8)
    at.save_tile_entry(at.tile_key("cpu", 8, 8, 8, "float32"), ("tilerows", 2))
    assert pick(None, None) == ("tilerows", 2)
    assert bsp.launch_tiles(None, None, 8, 8, 8, torch.bfloat16, stacks, cpu) == ("tilerows", 8)
    assert pick("tile64", None) == ("tile64", 1)
    assert pick("tilerows", None) == ("tilerows", 8)
    assert pick("tilerows", 4) == ("tilerows", 4)
    for engine, pack in ((None, 2), ("tilerows", 9), ("tilerows", 0), ("tile64", 2),
                         ("tile128", 1), ("tile32", 1), ("tilerows", True)):
        with pytest.raises(ValueError):
            pick(engine, pack)
    assert [bsp.pack_id("tilerows", p, 8, 200) for p in (None, 1, 16)] == [0, 1, 16]


def test_the_dispatch_span_records_the_tuned_tiles(tile_cache):
    """``tiles = [engine, pack]`` on each executed dispatch span, ``engine``
    its first item: the rule's with an empty cache, the cached pair once one
    is saved (a new plan cache, since an executable keeps its pick)."""
    import repro_torch.obs as tobs
    from repro_torch.core import BSMatrix
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import PlanCache, dist_multiply, scatter

    rng = np.random.default_rng(0)
    dense = rng.standard_normal((64, 64)).astype(np.float32)
    dense[np.abs(np.subtract.outer(np.arange(64), np.arange(64))) > 12] = 0
    x = scatter(BSMatrix.from_dense(dense, 8, device="cpu"), make_worker_mesh(4, "cpu"))

    def spans():
        tr = tobs.Tracer(sync=False)
        dist_multiply(x, x, PlanCache(tracer=tr))
        return [sp.args for sp in tr.spans if sp.name == "dispatch" and "tasks" in sp.args]

    rule = spans()
    assert rule and all(a["tiles"] == ["tilerows", 8] and a["engine"] == "tilerows" for a in rule)
    at.save_tile_entry(at.tile_key("cpu", 8, 8, 8, "float32"), ("tile64", 1))
    tuned = spans()
    assert tuned and all(a["tiles"] == ["tile64", 1] and a["engine"] == "tile64" for a in tuned)


@pytest.mark.parametrize("impl,bs,offset,rule", [("fused", 8, 0, ("tilerows", 8)),
                                                 ("fused", 128, 0, ("tile128", 1)),
                                                 ("fused", 128, 1, ("tile64", 1)),
                                                 ("ref", 32, 0, ("tilerows", 2)),
                                                 ("ref", 128, 1, ("tile128", 1))])
def test_the_span_records_the_tiles_the_executable_hands_the_kernel(monkeypatch, tile_cache,
                                                                    impl, bs, offset, rule):
    """One decision: the executable picks once per dtype and alignment of
    all the operand stacks it launches on (the staged engine's are gathered
    copies, aligned whatever the stores), hands that pair to the kernel's
    route, and the dispatch span records the same pair; a cache tuned
    mid-process moves a new executable only."""
    import repro_torch.core.distributed as cdist
    import repro_torch.obs as tobs
    from repro_torch.core import BSMatrix
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import PlanCache, dist_multiply, scatter
    from repro_torch.kernels import ops

    handed, picks = [], []
    for name in ("fused_block_spmm", "block_spmm_tensors"):
        real = getattr(ops, name)

        def spy(*a, _real=real, tiles=None, **kw):
            handed.append(tiles)
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, spy)
    real_pick = cdist.launch_tiles
    monkeypatch.setattr(cdist, "launch_tiles", lambda *a: picks.append(a[:5]) or real_pick(*a))
    n = 4 * bs
    rng = np.random.default_rng(bs)
    dense = rng.standard_normal((n, n)).astype(np.float32)
    dense[np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > bs] = 0
    x = scatter(BSMatrix.from_dense(dense, bs, device="cpu"), make_worker_mesh(4, "cpu"))
    if offset:
        x = dataclasses.replace(x, store=_stack(tuple(x.store.shape), offset).copy_(x.store))

    def run(cache):
        handed.clear()
        cache.tracer = tr = tobs.Tracer(sync=False)
        dist_multiply(x, x, cache, impl=impl)
        spans = [sp.args for sp in tr.spans if sp.name == "dispatch" and "tasks" in sp.args]
        return [tuple(t) for t in handed], [tuple(sp["tiles"]) for sp in spans]

    cache = PlanCache()
    for _ in range(3):
        assert run(cache) == ([rule], [rule])
    assert len(picks) == 1  # taken once, kept by the executable
    at.save_tile_entry(at.tile_key("cpu", bs, bs, bs, "float32"), ("tile64", 1))
    assert run(cache) == ([rule], [rule])
    assert run(PlanCache()) == ([("tile64", 1)], [("tile64", 1)])
