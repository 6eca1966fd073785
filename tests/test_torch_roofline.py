"""The port's roofline tools (``repro_torch.roofline``) against the JAX
package's (``repro.roofline``).

* ``model_flops_per_device`` equals the reference's for every
  architecture, shape and device count of the dry run;
* ``roofline_row``'s terms, times each package's own constants, give
  back the same record in both packages; ``format_table``'s layout is
  the reference's;
* ``count_ops`` counts llama3.2-1b's smoke forward as a closed form: two
  FLOPs per matmul parameter per token, plus the attention products
  (every chunk's scores and weighted values over the whole sequence);
  and a train step as ``FlopCounterMode`` does.
"""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as JSHAPES
from repro.roofline import analysis as janalysis
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.models import transformer
from repro_torch.roofline import analysis
from repro_torch.roofline.op_cost import count_ops
from repro_torch.train import TrainConfig, init_train_state, make_train_step

#: a dry-run record as both packages' dry runs write it
RECORD = {
    "arch": "llama3.2-1b", "shape": "train_4k", "mesh": "single", "status": "OK",
    "n_devices": 256, "flops_per_device": 3.1e14, "hbm_bytes_per_device": 2.2e12,
    "collective_total_per_device": 8.5e10, "memory": {"temp_bytes": 6.0e10},
}


def test_shapes_match_reference():
    assert {k: (v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_configs())
def test_model_flops_match_reference(arch, shape):
    for n in (1, 256, 512):
        assert analysis.model_flops_per_device(arch, shape, n) == \
            janalysis.model_flops_per_device(arch, shape, n), n


def test_constants_are_the_h100s():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert (analysis.DEVICE, analysis.POWER_LIMIT_W) == ("NVIDIA H100 80GB HBM3", 700)


@pytest.mark.parametrize("status", ["OK", "SKIP"])
def test_roofline_row_terms_match_reference(status):
    rec = dict(RECORD, status=status)
    got, want = analysis.roofline_row(rec), janalysis.roofline_row(rec)
    if status != "OK":
        assert got is None and want is None
        return
    for row, mod in ((got, analysis), (want, janalysis)):
        assert row.compute_s * mod.PEAK_FLOPS == pytest.approx(rec["flops_per_device"])
        assert row.memory_s * mod.HBM_BW == pytest.approx(rec["hbm_bytes_per_device"])
        assert row.collective_s * mod.LINK_BW == pytest.approx(
            rec["collective_total_per_device"])
    assert (got.model_flops_per_dev, got.hlo_flops_per_dev, got.temp_bytes) == (
        want.model_flops_per_dev, want.hlo_flops_per_dev, want.temp_bytes)
    assert got.useful_ratio == want.useful_ratio
    dom = max(got.compute_s, got.memory_s, got.collective_s)
    assert got.roofline_fraction == pytest.approx(
        got.model_flops_per_dev / analysis.PEAK_FLOPS / dom)


def test_format_table_layout_matches_reference(monkeypatch):
    rows = []
    for shape, scale in (("train_4k", 1.0), ("decode_32k", 1e-3)):
        rec = dict(RECORD, shape=shape,
                   **{k: RECORD[k] * scale for k in ("flops_per_device",
                                                     "hbm_bytes_per_device")})
        rows.append(rec)
    # the same numbers under the reference's constants give its table
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(analysis, name, getattr(janalysis, name))
    got = analysis.format_table([analysis.roofline_row(r) for r in rows])
    want = janalysis.format_table([janalysis.roofline_row(r) for r in rows])
    assert got == want
    assert len(got.splitlines()) == 4


def test_full_table_reads_records(tmp_path):
    import json

    for i, (mesh, status) in enumerate((("single", "OK"), ("multi", "OK"),
                                        ("single", "SKIP"))):
        with open(tmp_path / f"r{i}.json", "w") as f:
            json.dump(dict(RECORD, mesh=mesh, status=status), f)
    assert len(analysis.load_dryrun(str(tmp_path))) == 3
    rows = analysis.full_table(str(tmp_path))
    assert [(r.arch, r.mesh) for r in rows] == [("llama3.2-1b", "single")]
    assert rows[0].bottleneck == "memory"  # 2.2e12 B over 3.35e12 B/s: 0.66 s


def _forward_closed_form(cfg, b: int, s: int) -> int:
    """2 FLOPs per matmul parameter per token, plus the attention's two
    products over the whole sequence per head and layer."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * cfg.d_ff
    matmul = cfg.n_layers * per_layer + d * cfg.vocab_size  # + the unembedding
    attention = cfg.n_layers * 2 * (2 * b * h * s * s * hd)
    return 2 * b * s * matmul + attention


def test_count_ops_forward_flops_closed_form():
    cfg = get_config("llama3.2-1b", smoke=True)
    assert cfg.moe is None and not cfg.qk_norm
    b, s = 2, 32
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32)}
    with torch.no_grad():
        (loss, _), cost = count_ops(transformer.forward_train, params, cfg, batch)
    assert torch.isfinite(loss)
    assert cost.flops == _forward_closed_form(cfg, b, s)
    assert cost.collective_bytes == {} and cost.per_collective_ops == 0
    # the inputs are read once: the parameters and the tokens
    n_bytes = sum(p.numel() * 4 for p in params.parameters()) + b * s * 4
    assert cost.input_bytes == n_bytes
    assert cost.bytes_written > cost.temp_bytes > 0


def test_count_ops_train_step_matches_flop_counter():
    cfg = get_config("llama3.2-1b", smoke=True)
    tcfg = TrainConfig()
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32)}
    step = make_train_step(cfg, tcfg)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, tcfg)
    with FlopCounterMode(display=False) as counter:
        step(state, batch)
    (_, metrics), cost = count_ops(step, state, batch)
    assert cost.flops == counter.get_total_flops()
    # forward, the rematerialised forward and the backward's two products
    assert cost.flops == pytest.approx(4 * _forward_closed_form(cfg, 2, 16), rel=0.2)
    assert torch.isfinite(metrics["loss"])
    # the state comes back (updated in place) with the scalar metrics
    assert cost.output_bytes == cost.input_bytes - 2 * 16 * 4 + 4 * len(metrics)
