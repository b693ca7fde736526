"""The index on the card: ``E2LSHoS.build`` behind ``SearchEngine``, every
table, block and vector in device memory."""
from portbench.program import Served, build_index


def build(cfg, data, family_seed, device, work_dir, layout):
    from repro_torch.core import SearchEngine
    idx, params, params_off = build_index(cfg, data.db, family_seed, device)
    return Served(SearchEngine(idx, device=device), cfg, params, params_off)
