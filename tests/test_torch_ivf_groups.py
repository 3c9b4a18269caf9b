"""The work list of the port's tensor-core per-query IVF kernel
(super_rag_tpu_torch/ops/ivf_topk.py ``probe_groups``) and the choice of
kernel variant, on the CPU.

The kernel turns the per-query route tile-major: the (query, probe) pairs
are stably sorted by tile and cut into groups of at most QG pairs of one
tile, and each block finds its group by a binary search over the per-tile
group offsets.  ``_decode`` below reads the list as the kernel's blocks do
(csrc/ivf_scan.cu ``GroupList``), so the tests hold the list to what the
kernel assumes, and a scorer written from it to ``probe_scores_plain``."""

import numpy as np
import pytest
import torch

from super_rag_tpu_torch.ops import ivf_topk as tit


def _probes(kind, b, nlist, nprobe, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":  # repeats inside a row are allowed
        p = rng.integers(0, nlist, (b, nprobe))
    elif kind == "repeated":  # every query lists a tile twice
        p = rng.integers(0, nlist, (b, nprobe))
        p[:, 1] = p[:, 0]
    elif kind == "every_tile":  # nprobe = nlist
        p = np.stack([rng.permutation(nlist) for _ in range(b)])
    elif kind == "one_tile":  # every query probes the same tile
        p = rng.integers(0, nlist, (b, nprobe))
        p[:, nprobe // 2] = 5
    elif kind == "two_tiles":  # every query on two tiles only
        p = np.tile(np.array([7, 3]), (b, nprobe // 2 + 1))[:, :nprobe]
    else:
        raise ValueError(kind)
    return torch.from_numpy(p.astype(np.int32))


# kind: (B, nlist, nprobe); B * nprobe is a multiple of no QG below
CASES = {"random": (13, 16, 5), "repeated": (21, 9, 3),
         "every_tile": (7, 12, 12), "one_tile": (37, 12, 1),
         "two_tiles": (45, 10, 3)}


def _decode(groups, qg):
    """[(tile, [pair ids])] for every block of the grid that has work,
    found as the kernel's blocks find it."""
    go = groups.group_off.tolist()
    po = groups.pair_off.tolist()
    order = groups.order.tolist()
    nlist = len(go) - 1
    blocks = []
    for g in range(groups.max_groups):
        if g >= go[nlist]:
            continue  # past the last group: the block exits
        lo, hi = 0, nlist
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if go[mid] <= g else (lo, mid)
        first = po[lo] + (g - go[lo]) * qg
        blocks.append((lo, order[first:min(first + qg, po[lo + 1])]))
    return blocks


@pytest.mark.parametrize("qg", [8, 16, 32])
@pytest.mark.parametrize("kind", list(CASES))
def test_probe_groups_cover_each_pair_once_in_tile_order(kind, qg):
    b, nlist, nprobe = CASES[kind]
    probes = _probes(kind, b, nlist, nprobe)
    groups = tit.probe_groups(probes, nlist, qg)
    n_pairs = b * nprobe
    assert groups.order.dtype == groups.pair_off.dtype == torch.int32
    assert groups.group_off.dtype == torch.int32
    assert groups.max_groups == -(-n_pairs // qg) + min(nlist, n_pairs)
    blocks = _decode(groups, qg)
    flat = probes.reshape(-1).tolist()
    pairs = [p for _, ps in blocks for p in ps]
    assert sorted(pairs) == list(range(n_pairs))  # every pair exactly once
    assert pairs == sorted(range(n_pairs), key=lambda p: flat[p])  # stable
    tiles = [t for t, _ in blocks]
    assert tiles == sorted(tiles)
    for tile, ps in blocks:
        assert 1 <= len(ps) <= qg
        assert all(flat[p] == tile for p in ps)  # one tile a group
    # as few groups as the cut allows: ceil(count / qg) per tile
    counts = np.bincount(flat, minlength=nlist)
    assert len(blocks) == int(np.sum(-(-counts // qg)))
    assert len(blocks) <= groups.max_groups


def test_probe_groups_split_one_tile_over_many_groups():
    """All 37 queries on tile 5 at QG = 8: five groups of that tile, the
    last one short."""
    probes = torch.full((37, 1), 5, dtype=torch.int32)
    groups = tit.probe_groups(probes, 12, 8)
    blocks = _decode(groups, 8)
    assert [t for t, _ in blocks] == [5] * 5
    assert [len(ps) for _, ps in blocks] == [8, 8, 8, 8, 5]
    assert groups.group_off.tolist() == [0] * 6 + [5] * 7


def _scores_from_groups(q, probes, groups, qg, values, scales, cs, row_ids,
                        mask):
    """The per-query scores written from the work list, block by block,
    with the kernels' epilogue (NaN where no block wrote)."""
    b, nprobe = probes.shape
    cap = values.shape[1]
    out = torch.full((b * nprobe, cap), float("nan"))
    for tile, pairs in _decode(groups, qg):
        p = torch.tensor(pairs)
        qb = p // nprobe
        s = q[qb].to(torch.float32) @ values[tile].to(torch.float32).T
        if scales is not None:
            s = s * scales[tile]
        if cs is not None:
            s = s + cs[qb, tile][:, None]
        rid = row_ids[tile]
        keep = rid >= 0
        if mask is not None:
            keep = keep & mask[rid.clamp(min=0).long()]
        out[p] = torch.where(keep, s, float("-inf"))
    return out.reshape(b, nprobe, cap)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("residual,masked", [(False, False), (True, True),
                                             (True, False)])
@pytest.mark.parametrize("kind", ["random", "every_tile", "two_tiles"])
def test_scorer_from_work_list_equals_plain_version(kind, dtype, residual,
                                                    masked):
    """Small integer queries and values make every dot product exact in
    f32 whatever the order, so the work-list scorer and
    ``probe_scores_plain`` agree bit for bit: the list routes each pair's
    scores to out[b, j] and adds cs[b, tile] of the right query."""
    b, nlist, nprobe = CASES[kind]
    cap, d = 40, 48
    rng = np.random.default_rng(3)
    values = torch.from_numpy(rng.integers(-8, 9, (nlist, cap, d))).to(dtype)
    scales = (torch.from_numpy(rng.random((nlist, cap), np.float32))
              if dtype == torch.int8 else None)
    q = torch.from_numpy(rng.integers(-8, 9, (b, d))).to(torch.bfloat16)
    row_ids = torch.from_numpy(
        rng.permutation(nlist * cap).reshape(nlist, cap).astype(np.int32))
    row_ids[torch.from_numpy(rng.random((nlist, cap)) < 0.2)] = -1
    cs = (torch.from_numpy(rng.standard_normal((b, nlist), np.float32))
          if residual else None)
    mask = (torch.from_numpy(rng.random(nlist * cap) < 0.7) if masked
            else None)
    probes = _probes(kind, b, nlist, nprobe, seed=4)
    qg = 8
    groups = tit.probe_groups(probes, nlist, qg)
    got = _scores_from_groups(q, probes, groups, qg, values, scales, cs,
                              row_ids, mask)
    ref = tit.probe_scores_plain(q, probes, values, scales, cs, row_ids, mask)
    assert not torch.isnan(got).any()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype,want", [(torch.int8, "tc"),
                                        (torch.bfloat16, "tc"),
                                        (torch.float32, "tc"),
                                        (torch.float16, ValueError)])
def test_probe_variant_by_mode(dtype, want):
    """Every values type takes the tensor-core per-query kernel over the
    work list (f32 values as three TF32 products, which keep the
    summation tolerance); a mode the kernel does not have raises."""
    if want is ValueError:
        with pytest.raises(ValueError, match="no per-query kernel mode"):
            tit.probe_variant(max(tit.MODES.values()) + 1)
        assert dtype not in tit.MODES
        return
    assert tit.probe_variant(tit.MODES[dtype]) == want
