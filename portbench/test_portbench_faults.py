"""The check sees a broken timed path: each fault the cells can have, planted
in the program underneath a whole run on the host, turns ``correct`` false."""
import pytest

from portbench.harness import run_cell

SEED = 2**31 + 31337
N = 3000          # the small configuration's database rows
INVALID = 2**31 - 1


def _altered_answer(orig):
    def fault(state, cfg, valid=None):
        res = orig(state, cfg, valid)
        ids = res.ids.clone()
        if ids[0, 0] != INVALID:
            ids[0, 0] = (ids[0, 0] + 1) % N      # another row, the old distance
        res.ids = ids
        return res
    return fault


def _one_row_short(orig):
    def fault(state, cfg, valid=None):
        res = orig(state, cfg, valid)
        ids, dists = res.ids.clone(), res.dists.clone()
        n = int((ids[0] != INVALID).sum())
        if n:
            ids[0, n - 1] = INVALID               # the first row of each batch loses
            dists[0, n - 1] = float("inf")        # its farthest answer, consistently
        res.ids, res.dists = ids, dists
        return res
    return fault


def _half_left_out(orig):
    def fault(Q, cfg, device, valid=None):
        state = list(orig(Q, cfg, device, valid))
        done = state[2].clone()
        done[Q // 2:] = True                      # the second half is never searched
        state[2] = done
        return tuple(state)
    return fault


def _state_unchanged(orig):
    def fault(state, *args, **kwargs):
        return state
    return fault


# fault -> (the function of the plans it replaces, its replacement's maker)
FAULTS = {"altered_answer": ("_result_from_state", _altered_answer),
          "one_row_short": ("_result_from_state", _one_row_short),
          "half_left_out": ("_init_state", _half_left_out),
          "state_unchanged": ("_update_state", _state_unchanged)}


@pytest.mark.parametrize("cell,fault", [
    ("tiny.batch", "altered_answer"), ("tiny.batch", "half_left_out"),
    ("tiny.batch", "state_unchanged"), ("tiny-spill.batch", "altered_answer"),
    ("tiny-spill.batch", "state_unchanged"), ("tiny-spill.batch", "one_row_short"),
    ("tiny.batch256", "one_row_short")])
def test_a_fault_in_the_timed_path_is_not_correct(bench_root, tmp_path, monkeypatch,
                                                   cell, fault):
    from repro_torch.core import query
    from repro_torch.storage import external
    name, make = FAULTS[fault]
    fn = make(getattr(query, name))
    monkeypatch.setattr(query, name, fn)
    monkeypatch.setattr(external, name, fn)
    out = run_cell(bench_root, cell, seed=SEED, seconds=0.4, trace=False, device="cpu",
                   work_dir=tmp_path / "work")
    assert not out["correct"], out["checks"]
    failing = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert set(failing) & {"rows_off", "dist_err"}, out["checks"]
    if fault == "one_row_short":     # its distances stay consistent: rows_off alone
        assert failing == ["rows_off"], out["checks"]

