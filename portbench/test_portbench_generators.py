"""The benchmark's generators are fixed by the seed: data, traffic and the
hash family."""
import torch

from portbench.data import DataSpec, held_out_mask, make_dataset
from portbench.reference import RefParams, family_from_seed

SPEC = DataSpec(n=2000, d=16, clusters=10, spread=0.15)
BIG_SEED = 2**31 + 987_654_321


def test_data_is_fixed_by_the_seed_and_moves_with_it():
    a = make_dataset(SPEC, 256, BIG_SEED, "cpu")
    b = make_dataset(SPEC, 256, BIG_SEED, "cpu")
    c = make_dataset(SPEC, 256, BIG_SEED + 1, "cpu")
    assert torch.equal(a.db, b.db) and torch.equal(a.queries, b.queries)
    assert a.scale == b.scale
    assert not torch.equal(a.db, c.db)


def test_data_keeps_the_specs_shape():
    ds = make_dataset(SPEC, 400, 5, "cpu")
    assert ds.db.shape == (2000, 16) and ds.queries.shape == (400, 16)
    assert ds.db.dtype == torch.float32
    levels = torch.unique(torch.round(ds.db * ds.scale))
    assert torch.allclose(ds.db * ds.scale, torch.round(ds.db * ds.scale), atol=1e-3)
    assert levels.min() >= 0 and levels.max() <= 255
    # the median 1-NN distance of the scaled queries sits at the target
    d2 = torch.cdist(ds.queries.double(), ds.db.double())
    assert abs(float(d2.min(1).values.median()) - SPEC.nn_target) < 1e-5


def test_the_query_mix_is_spread_evenly():
    hard = held_out_mask(4096, 0.75)
    assert int(hard.sum()) == 1024
    assert all(int(hard[i:i + 256].sum()) == 64 for i in range(0, 4096, 256))
    assert hard[3] and not hard[:3].any()


def test_the_family_is_the_programs_draw_from_the_same_seed():
    from repro_torch.core.hashing import make_hash_family
    p = RefParams(d=16, m=5, L=3, r=4, S=8, u=10, fp_bits=16, w=4.0, c=2.0,
                  block_objs=99, max_chain=2, k=3)
    mine = family_from_seed(BIG_SEED % (2**31 - 1), p)
    prog = make_hash_family(r=4, L=3, m=5, d=16, w=4.0, u=10, fp_bits=16,
                            generator=torch.Generator().manual_seed(BIG_SEED % (2**31 - 1)),
                            device="cpu")
    assert torch.equal(mine.a, prog.a) and torch.equal(mine.b, prog.b)
    assert torch.equal(mine.rm, prog.rm.to(torch.int64) & 0xFFFFFFFF)
    assert bool((mine.rm % 2 == 1).all())
