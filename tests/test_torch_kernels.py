"""repro_torch kernels' plain versions vs the JAX reference, bit for bit.

Every lane here is integer, so every comparison is exact (tolerance 0).
The reference's Pallas kernels run in interpret mode, as its own tests run
them; the CUDA kernels themselves are held against these plain versions on
the card (tests/test_torch_boundary.py, chip_smoke.py).
"""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bloom as ref_bloom
from repro.core.faults import crc32c as ref_crc32c
from repro.core.faults import crc32c_rows as ref_crc32c_rows
from repro.core.memtable import WriteAheadLog as RefWAL
from repro.core.run import build_run as ref_build_run
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.merge_path import merge_path_partition as \
    ref_merge_path_partition
from repro_torch.core.bloom import BloomFilter
from repro_torch.core.faults import CHUNK, crc32c_rows, crc32c_rows_torch
from repro_torch.core.memtable import WriteAheadLog
from repro_torch.core.run import build_run
from repro_torch.core.types import IOStats
from repro_torch.kernels import bloom, merge, ops

# the package exports a function of the same name as this module
ref_bloom_probe = importlib.import_module("repro.kernels.bloom_probe")

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

EDGE = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1],
                dtype=np.uint64)


def dev(keys) -> torch.Tensor:
    return ops.keys_to_device(keys, "cpu")


def words(bits: np.ndarray) -> torch.Tensor:
    """Reference uint32 filter words as the port's int32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(bits, np.uint32)
                            .view(np.int32))


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_key_map_round_trips_and_orders():
    rng = np.random.default_rng(0)
    keys = np.concatenate([EDGE, rng.integers(0, 2**64 - 1, 1000,
                                              dtype=np.uint64)])
    mapped = ops.to_order(keys)
    np.testing.assert_array_equal(ops.from_order(mapped), keys)
    np.testing.assert_array_equal(np.argsort(mapped, kind="stable"),
                                  np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(ops.keys_from_device(dev(keys)), keys)


def test_hash_pair_matches_both_reference_hashes():
    rng = np.random.default_rng(1)
    keys = np.concatenate([EDGE, rng.integers(0, 2**64 - 1, 4096,
                                              dtype=np.uint64)])
    h1, h2 = bloom.hash_pair(dev(keys))
    r1, r2 = ref_bloom.hash_pair(keys)
    lo, hi = ref_ops.split_u64(keys)
    k1, k2 = ref_bloom_probe.hash_pair(lo, hi)
    np.testing.assert_array_equal(u32(h1), r1)
    np.testing.assert_array_equal(u32(h2), r2)
    np.testing.assert_array_equal(u32(h1), np.asarray(k1))
    np.testing.assert_array_equal(u32(h2), np.asarray(k2))
    assert int(h1.max()) < 2**32 and int(h1.min()) >= 0


@pytest.mark.parametrize("n,m_words,k", [(512, 128, 5), (2048, 1024, 7),
                                         (4096, 64, 3)])
def test_probe_and_build_sweep_vs_pallas_and_ref(n, m_words, k):
    rng = np.random.default_rng(n + k)
    keys = rng.integers(0, 2**63, n, dtype=np.uint64)
    lo, hi = ref_ops.split_u64(keys)
    bits = ref_ref.bloom_build_ref(np.asarray(lo), np.asarray(hi), m_words, k)
    np.testing.assert_array_equal(
        bloom.build_plain(dev(keys), m_words, k).numpy().view(np.uint32), bits)
    # the Pallas wrapper takes whole query blocks; the jnp oracle any size
    queries = np.concatenate([keys, rng.integers(0, 2**64 - 1, n,
                                                 dtype=np.uint64)])
    got = bloom.probe_plain(dev(queries), words(bits), k).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_ops.bloom_probe(queries, jnp.asarray(bits), k)))
    queries = np.concatenate([queries, EDGE])
    got = bloom.probe_plain(dev(queries), words(bits), k).numpy()
    qlo, qhi = ref_ops.split_u64(queries)
    np.testing.assert_array_equal(
        got, np.asarray(ref_ref.bloom_probe_ref(qlo, qhi, jnp.asarray(bits),
                                                k)))
    assert got[:n].all()            # no false negatives on members


def test_probe_false_positive_rate_reasonable():
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 2**62, 4096, dtype=np.uint64)
    bits = bloom.build_plain(dev(keys), 2048, 7)
    absent = rng.integers(2**62, 2**63, 8192, dtype=np.uint64)
    assert float(bloom.probe_plain(dev(absent), bits, 7).float().mean()) \
        < 0.05


@pytest.mark.parametrize("nq", [0, 1, 64, 512, 700])
def test_probe_matches_bloomfilter_at_query_sizes(nq):
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**63, 900, dtype=np.uint64)
    ref = ref_bloom.BloomFilter(keys, bits_per_key=10)
    port = BloomFilter(dev(keys), 10)
    np.testing.assert_array_equal(port.bits_numpy(), ref.bits)
    assert (port.m_bits, port.k) == (ref.m_bits, ref.k)
    q = rng.integers(0, 2**63, nq, dtype=np.uint64)
    np.testing.assert_array_equal(port.may_contain(dev(q)).numpy(),
                                  ref.may_contain(q))
    if nq:
        np.testing.assert_array_equal(port.may_contain(dev(q)).numpy(),
                                      ref_ops.bloom_probe_filter(ref, q))


@pytest.mark.parametrize("n,bpk", [(1, 10.0), (37, 3.0), (900, 10.0),
                                   (5000, 7.5), (300, 0.0), (0, 10.0)])
def test_build_matches_build_bits(n, bpk):
    rng = np.random.default_rng(n)
    keys = np.concatenate([EDGE, rng.integers(0, 2**64 - 1, n,
                                              dtype=np.uint64)])[:n]
    ref = ref_bloom.BloomFilter(keys, bpk)
    port = BloomFilter(dev(keys), bpk)
    assert (port.m_bits, port.k) == (ref.m_bits, ref.k)
    np.testing.assert_array_equal(port.bits_numpy(), ref.bits)
    if ref.k:
        h1, h2 = ref_bloom.hash_pair(keys)
        np.testing.assert_array_equal(
            port.bits_numpy(), ref_bloom.build_bits(h1, h2, ref.k, ref.m_bits))


def assert_merge_matches_reference(a: np.ndarray, b: np.ndarray, tile: int):
    mk, mp = ref_ops.merge_runs_tiled(a, b, tile=tile)
    keys, src = merge.merge_pair_plain(torch.from_numpy(ops.to_order(a)),
                                       torch.from_numpy(ops.to_order(b)))
    got = ops.from_order(keys.numpy(), a.dtype)
    assert got.dtype == mk.dtype
    np.testing.assert_array_equal(got, mk)
    np.testing.assert_array_equal(src.numpy(), mp.astype(np.int64))


@pytest.mark.parametrize("na,nb,tile", [(777, 1333, 256), (1, 5000, 128),
                                        (256, 256, 256), (0, 100, 64),
                                        (100, 0, 64), (4096, 4096, 512)])
def test_merge_sweep_vs_merge_runs_tiled(na, nb, tile):
    rng = np.random.default_rng(na + nb)
    a = np.sort(rng.integers(0, 1 << 31, na, dtype=np.uint32))
    b = np.sort(rng.integers(0, 1 << 31, nb, dtype=np.uint32))
    assert_merge_matches_reference(a, b, tile)


@pytest.mark.parametrize("dt,lo,hi", [(np.int64, -2**60, 2**60),
                                      (np.int32, -2**31, 2**31 - 1),
                                      (np.uint64, 0, 2**63)])
def test_merge_signed_and_wide_dtypes(dt, lo, hi):
    rng = np.random.default_rng(11)
    a = np.sort(rng.integers(lo, hi, 700).astype(dt))
    b = np.sort(rng.integers(lo, hi, 900).astype(dt))
    assert_merge_matches_reference(a, b, 128)


def test_merge_u64_max_and_duplicates_across_sides():
    top = np.iinfo(np.uint64).max
    assert_merge_matches_reference(np.array([0, 1, 5, 2**63, top], np.uint64),
                                   np.array([2, 5, 9, 2**63 - 1, top],
                                            np.uint64), 64)
    rng = np.random.default_rng(5)
    a = np.sort(rng.integers(0, 50, 300).astype(np.uint64))
    b = np.sort(rng.integers(0, 50, 200).astype(np.uint64))
    assert_merge_matches_reference(a, b, 64)


def test_merge_row_limit_is_the_reference_limit():
    with pytest.raises(ValueError):
        merge._check_rows(merge.MAX_ROWS + 1, 0)
    with pytest.raises(ValueError):
        merge._check_rows(0, merge.MAX_ROWS + 1)
    merge._check_rows(merge.MAX_ROWS, merge.MAX_ROWS)


@pytest.mark.parametrize("n,width", [(0, 8), (1, 1), (257, 40), (64, 0)])
def test_crc32c_rows_torch_matches_reference(n, width):
    rng = np.random.default_rng(n + width)
    mat = rng.integers(0, 256, (n, width), dtype=np.uint8)
    lens = rng.integers(0, width + 1, n)
    got = crc32c_rows_torch(torch.from_numpy(mat), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  ref_crc32c_rows(mat, lens))


def edge_lengths(rng, n: int, width: int) -> np.ndarray:
    """Row lengths around every chunk boundary, then random ones."""
    edges = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK - 1, 2 * CHUNK,
             2 * CHUNK + 1, width - 1, width]
    lens = rng.integers(0, width + 1, n)
    lens[:len(edges)] = [min(e, width) for e in edges][:n]
    return lens


@pytest.mark.parametrize("n,width", [(12, CHUNK + 1), (12, 2 * CHUNK + 1),
                                     (40, 3000), (3, 5 * CHUNK)])
def test_long_row_crcs_match_reference(n, width):
    """Matrices wider than one chunk take the chunk-and-combine path, on
    the host (numpy) and on a device (torch): bit for bit the reference's
    byte loop, for lengths just below, at and above each chunk."""
    rng = np.random.default_rng(n * width)
    mat = rng.integers(0, 256, (n, width), dtype=np.uint8)
    lens = edge_lengths(rng, n, width)
    want = ref_crc32c_rows(mat, lens)
    np.testing.assert_array_equal(crc32c_rows(mat, lens), want)
    got = crc32c_rows_torch(torch.from_numpy(mat), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_one_mib_rows_match_the_scalar_oracle():
    """1 MiB rows against the reference's scalar ``crc32c``, the oracle its
    ``crc32c_rows`` is defined to equal (that byte loop takes ~15 s here)."""
    rng = np.random.default_rng(1)
    mat = rng.integers(0, 256, (3, 1 << 20), dtype=np.uint8)
    lens = np.array([1 << 20, (1 << 20) - 3, 5 * CHUNK + 7])
    want = [ref_crc32c(mat[i, :lens[i]].tobytes()) for i in range(3)]
    assert crc32c_rows(mat, lens).tolist() == want
    got = crc32c_rows_torch(torch.from_numpy(mat), torch.from_numpy(lens))
    assert got.tolist() == want


def test_wal_frames_of_long_values_match_reference():
    """The WAL's scalar append checksums long messages by chunks; frames
    stay byte-identical to the reference's."""
    ref_wal, wal = RefWAL(), WriteAheadLog()
    rng = np.random.default_rng(2)
    for n in (0, 5, CHUNK - 25, CHUNK - 20, 3 * CHUNK, 50_000):
        value = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        ref_wal.append(0, n, n + 1, value, IOStats())
        wal.append(0, n, n + 1, value, IOStats())
    assert bytes(wal._buf) == bytes(ref_wal._buf)


def test_block_crcs_of_long_values_and_tombstones_match_reference():
    """Entry checksums of a run whose values exceed one chunk (the AutumnKV
    page case), with tombstones, feed identical block checksums."""
    rng = np.random.default_rng(3)
    n, vmax = 9, 3 * CHUNK + 5
    keys = rng.choice(2**62, n, replace=False).astype(np.uint64)
    keys[0] = 2**64 - 1
    seqs = np.arange(1, n + 1, dtype=np.uint64)
    vlens = rng.integers(0, vmax + 1, n).astype(np.int32)
    vlens[[1, 4]] = -1                        # tombstones
    vlens[2] = vmax
    vals = rng.integers(0, 256, (n, vmax), dtype=np.uint8)
    vals[np.arange(vmax)[None] >= np.maximum(vlens, 0)[:, None]] = 0
    ref_run = ref_build_run(keys, seqs, vlens, vals, block_size=4096)
    run = build_run(ops.keys_to_device(keys, "cpu"),
                    torch.from_numpy(seqs.view(np.int64)),
                    torch.from_numpy(vlens), torch.from_numpy(vals),
                    block_size=4096)
    np.testing.assert_array_equal(run.block_crcs.numpy().astype(np.uint32),
                                  ref_run.block_crcs)


def test_cpu_tensors_take_the_plain_version_and_count_it():
    ops.reset_launch_counts()
    keys = dev(np.arange(10, dtype=np.uint64))
    bits = ops.bloom_build(keys, 4, 3)
    assert ops.bloom_probe(keys, bits, 3).all()
    ops.merge_pair(keys, keys)
    assert ops.PLAIN_CALLS == {"bloom_probe": 1, "bloom_build": 1,
                               "merge_pair": 1, "flash_attention": 0,
                               "paged_attention": 0}
    assert set(ops.launch_counts().values()) == {0}


def test_cuda_wrappers_refuse_cpu_tensors():
    keys = dev(np.arange(10, dtype=np.uint64))
    bits = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        bloom.probe_cuda(keys, bits, 3)
    with pytest.raises(ValueError):
        bloom.build_cuda(keys, 4, 3)
    with pytest.raises(ValueError):
        merge.merge_pair_cuda(keys, keys)
    assert set(ops.launch_counts().values()) == {0}


# ------------------------------------------------- the kernels' plans (CPU)
def test_fastmod_equals_remainder_at_the_edges():
    """Lemire's fastmod with a 64-bit magic, as the bloom build kernels
    reduce positions: equal to % for 32-bit numerators and divisors."""
    rng = np.random.default_rng(15)
    nums = [0, 1, 31, 32, 33, 2**31 - 1, 2**31, 2**32 - 33, 2**32 - 32,
            2**32 - 31, 2**32 - 2, 2**32 - 1] \
        + rng.integers(0, 2**32, 300).tolist()
    divs = [1, 2, 3, 32, 64, 96, 2**16, 2**31, 2**32 - 64, 2**32 - 33,
            2**32 - 32, 2**32 - 1] \
        + (rng.integers(1, 2**27, 40) * 32).tolist() \
        + rng.integers(1, 2**32, 40).tolist()
    for d in divs:
        magic = bloom.fastmod_magic(d)
        assert 0 <= magic < 2**64
        assert [bloom.fastmod(a, magic, d) for a in nums] == \
            [a % d for a in nums]


SMEM = bloom.H100_SMEM_OPTIN
SWITCH = SMEM // 4          # the largest filter, in words, of one block


@pytest.mark.parametrize("n,m_words,k", [
    (0, 1, 1), (1, 1, 7), (36_158, 11_300, 7), (1, SWITCH, 7),
    (100_000, SWITCH, 20), (1, SWITCH + 1, 7), (1_000_000, SWITCH + 1, 1),
    (1_000_000, 2048 * 29, 7), (1_000_000, 2048 * 29 + 1, 20),
    (1_000_000, 2048 * 30 - 1, 7), (10_000_000, 3_125_000, 7),
    (2**31, (2**32 - 32) // 32, 7), (5, 2**22 + 3, 3)])
def test_build_plan_covers_keys_and_words_once(n, m_words, k):
    """Chunks of keys and slices of words each cover their range exactly
    once; a bucket block's positions fit its stage and its shared memory,
    a slice's words fit one block's, and the bucket blocks cover the SMs
    while the keys allow."""
    plan = bloom.build_plan(n, m_words, k, SMEM, bloom.H100_SMS)
    assert plan.blocks == max(1, -(-n // plan.keys_per_block))
    assert (plan.blocks - 1) * plan.keys_per_block < max(n, 1) \
        <= plan.blocks * plan.keys_per_block
    sw = plan.slice_words
    starts = [s * sw for s in range(plan.n_slices)]
    ends = [min(s + sw, m_words) for s in starts]
    assert starts[0] == 0 and ends[-1] == m_words
    assert all(e > s for s, e in zip(starts, ends))
    assert all(e == s for e, s in zip(ends, starts[1:]))
    assert plan.n_slices <= bloom.MAX_SLICES
    assert plan.keys_per_block * k <= plan.stage <= bloom.STAGE
    assert bloom.bucket_smem(plan.stage, plan.n_slices) <= SMEM
    assert sw * 4 <= SMEM
    if plan.stage > bloom.MIN_STAGE:
        assert plan.blocks >= bloom.H100_SMS
    assert plan.cap % 8 == 0
    assert plan.cap >= n * k * (1 << plan.slice_shift) / (32 * m_words)
    assert plan.offset_bytes == (2 if plan.slice_shift <= 16 else 4)
    assert 12 <= plan.slice_shift <= 20


def test_build_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        bloom.build_plan(10, 0, 7)
    with pytest.raises(ValueError):
        bloom.build_plan(10, 1 << 27, 7)      # 2^32 bits
    with pytest.raises(ValueError):
        bloom.build_plan(10, 100, 0)


@pytest.mark.parametrize("n,m_words,k", [(20_000, SWITCH + 1, 7),
                                         (30_000, 2048 * 29 + 5, 3),
                                         (6_000, 2048 * 40, 20),
                                         (3_000, 11_300, 7)])
def test_build_plan_rebuilds_the_filter_slice_by_slice(n, m_words, k):
    """The build kernels' arithmetic in plain torch: positions by fastmod,
    bucketed by slice as in-slice offsets, each slice's words set on their
    own.  Random keys stay inside every segment's cap, and the slices'
    words, laid end to end, are ``build_plain``'s and the reference's."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    plan = bloom.build_plan(n, m_words, k, SMEM, bloom.H100_SMS)
    m_bits = 32 * m_words
    magic = bloom.fastmod_magic(m_bits)
    h1, h2 = (t.tolist() for t in bloom.hash_pair(dev(keys)))
    pos = torch.tensor([bloom.fastmod((a + j * b) & bloom.M32, magic, m_bits)
                        for a, b in zip(h1, h2) for j in range(k)])
    slice_of = pos >> plan.slice_shift
    counts = torch.bincount(slice_of, minlength=plan.n_slices)
    assert int(counts.max()) <= plan.cap
    assert int(counts.sum()) == n * k
    words = []
    for s in range(plan.n_slices):
        offs = pos[slice_of == s] & ((1 << plan.slice_shift) - 1)
        nw = min(plan.slice_words, m_words - s * plan.slice_words)
        bitmap = torch.zeros(nw * 32, dtype=torch.int64)
        bitmap[offs] = 1
        words.append((bitmap.view(nw, 32)
                      << torch.arange(32, dtype=torch.int64)).sum(1))
    got = bloom.u32_to_i32(torch.cat(words))
    assert torch.equal(got, bloom.build_plain(dev(keys), m_words, k))
    lo, hi = ref_ops.split_u64(keys)
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        ref_ref.bloom_build_ref(np.asarray(lo), np.asarray(hi), m_words, k))


MERGE_CASES = [(0, 1), (1, 0), (1, 5000), (5000, 1), (2048, 2048),
               (2047, 2049), (3000, 7000), (4096, 0), (10_000, 10)]


@pytest.mark.parametrize("na,nb", MERGE_CASES)
@pytest.mark.parametrize("dups", [False, True])
def test_merge_path_splits_equal_the_reference_partition(na, nb, dups):
    """The tile splits of the merge kernel (one binary search of the merge
    path per tile diagonal) against the reference's host
    ``merge_path_partition``, with duplicates within and across sides."""
    rng = np.random.default_rng(na * 7 + nb + dups)
    hi = 40 if dups else 2**64 - 1
    a = np.sort(rng.integers(0, hi, na, dtype=np.uint64))
    b = np.sort(rng.integers(0, hi, nb, dtype=np.uint64))
    for tile in (merge.TILE, 256):
        got = merge.merge_path_splits_plain(dev(a), dev(b), tile)
        ba, bb = ref_merge_path_partition(a, b, tile)
        np.testing.assert_array_equal(got.numpy(), ba)
        d = merge.tile_diagonals(na + nb, tile)
        np.testing.assert_array_equal((d - got).numpy(), bb)


@pytest.mark.parametrize("na,nb", MERGE_CASES + [(4000, 4000)])
def test_merge_tiles_cover_the_output_once_and_merge_to_the_contract(na, nb):
    """Tiles of TILE outputs at the splits: each takes a contiguous range
    of a and of b, the ranges cover both inputs exactly once, and merging
    each tile on its own (stable, a first) gives ``merge_pair_plain``."""
    rng = np.random.default_rng(na + 3 * nb)
    a = np.sort(rng.integers(0, 3 * (na + nb) + 1, na, dtype=np.uint64))
    b = np.sort(rng.integers(0, 3 * (na + nb) + 1, nb, dtype=np.uint64))
    ta, tb = dev(a), dev(b)
    ia = merge.merge_path_splits_plain(ta, tb).tolist()
    d = merge.tile_diagonals(na + nb).tolist()
    jb = [x - y for x, y in zip(d, ia)]
    assert ia[0] == jb[0] == 0 and ia[-1] == na and jb[-1] == nb
    assert all(x <= y for x, y in zip(ia, ia[1:]))
    assert all(x <= y for x, y in zip(jb, jb[1:]))
    assert all(e - s == min(merge.TILE, na + nb - s)
               for s, e in zip(d, d[1:]))
    keys, src = [], []
    for t in range(len(d) - 1):
        ka, kb = ta[ia[t]:ia[t + 1]], tb[jb[t]:jb[t + 1]]
        order = torch.sort(torch.cat([ka, kb]), stable=True).indices
        keys.append(torch.cat([ka, kb])[order])
        src.append(torch.cat([torch.arange(ia[t], ia[t + 1]),
                              torch.arange(jb[t], jb[t + 1])
                              | merge.FROM_B])[order])
    want = merge.merge_pair_plain(ta, tb)
    assert torch.equal(torch.cat(keys), want[0])
    assert torch.equal(torch.cat(src), want[1])


def test_launch_sizes_reset_with_the_counts():
    bloom.LAUNCH_SIZES["bloom_build"].append(5)
    bloom.LAUNCH_SIZES["bloom_probe"].append((3, 4))
    merge.LAUNCH_SIZES["merge_pair"].append((1, 2))
    assert ops.launch_sizes() == {"bloom_build": [5], "bloom_probe": [(3, 4)],
                                  "merge_pair": [(1, 2)]}
    ops.reset_launch_counts()
    assert ops.launch_sizes() == {"bloom_build": [], "bloom_probe": [],
                                  "merge_pair": []}
