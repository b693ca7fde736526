"""The plain reference agrees with the program's plain CPU path at a small
size, and the control (TF32 operands) does not pass the check."""
import pytest
import torch

from portbench.compare import Answers, judge
from portbench.conftest import TINY
from portbench.control import control_readings
from portbench.data import DataSpec, make_dataset
from portbench.reference import RefParams, Reference, family_from_seed, to_tf32

SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def tiny():
    data = make_dataset(DataSpec.from_config(TINY), 256, SEED, "cpu")
    p = RefParams.from_config(TINY)
    ref = Reference(data.db, family_from_seed(SEED % (2**31 - 1), p), p)
    return data, p, ref, ref.answer(data.queries)


@pytest.mark.parametrize("plan", ["fused", "oracle"])
def test_reference_agrees_with_the_programs_cpu_path(tiny, plan):
    from repro_torch.core import E2LSHoS, SearchEngine
    data, p, ref, want = tiny
    b = TINY["build"]
    idx = E2LSHoS.build(data.db, c=b["c"], w=b["w"], gamma=b["gamma"], max_L=b["max_L"],
                        block_bytes=b["block_bytes"], seed=SEED % (2**31 - 1), device="cpu")
    assert (idx.params.m, idx.params.L, idx.params.r, idx.params.u) == (p.m, p.L, p.r, p.u)
    res = SearchEngine(idx, device="cpu").query(data.queries, plan=plan, k=p.k)
    reading = judge(Answers.of(res), want, data.queries, ref)
    assert reading["rows_off"] == 0.0
    assert reading["dist_err"] < 1e-6
    assert reading["ambiguous"] < 0.2 * reading["rows"]
    assert int(want.found.sum()) > 0.9 * want.found.numel()


def test_the_reference_reads_its_own_answers_as_exact(tiny):
    data, p, ref, want = tiny
    mine = Answers(ids=want.ids.numpy(), dists=torch.sqrt(want.d2).float().numpy(),
                   found=want.found.numpy(), radii_searched=want.radii_searched.numpy(),
                   nio_table=want.nio_table.numpy(), nio_blocks=want.nio_blocks.numpy(),
                   cands_checked=want.cands_checked.numpy())
    reading = judge(mine, want, data.queries, ref)
    assert reading["rows_off"] == 0.0 and reading["dist_err"] < 1e-7


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(10_000, dtype=torch.float32) * 100
    y = to_tf32(x)
    assert bool(((y.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((y - x).abs() / x.abs()).max()) <= 2.0**-11
    assert torch.equal(to_tf32(y), y)


def test_the_control_fails_the_check(bench_root):
    reading, limits = control_readings(bench_root, "tiny.batch", SEED, "cpu")
    assert reading["rows_off"] > limits["rows_off"] or reading["dist_err"] > limits["dist_err"]
    assert reading["dist_err"] > 3 * 1e-6
