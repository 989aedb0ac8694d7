"""The port's Phase 3 adapter analysis (sar_tpu_torch/analysis/adapters.py
and scripts/analyze_adapters.py) against sar_tpu.analysis on the CPU:
`analyze_adapter`, `adapter_similarity` and `compare_adapters` over the
same JAX-saved random banks, and over PEFT directories made offline
(tests/_hf_tiny.py), equal to JAX's within 1e-6 (both are host numpy over
the same fp32 factors); the CLI's report and printout equal JAX's
`analyze_adapters.main`."""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _hf_tiny import make_tiny_model, peft_wrap, randomize_peft_lora, tiny_hf_config
from _torch_port import get_config

from sar_tpu import analysis as janalysis
from sar_tpu.analysis import adapters as jadapters
from sar_tpu.models import convert as jconvert
from sar_tpu.models import lora as jlora
from sar_tpu_torch import analysis as tanalysis
from sar_tpu_torch.analysis import adapters as tadapters
from sar_tpu_torch.models import convert as tconvert
from sar_tpu_torch.models import lora as tlora
from sar_tpu_torch.scripts import analyze_adapters

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import analyze_adapters as jax_analyze_adapters  # noqa: E402

CFG = get_config("whisper-test")
LANGS = ("english", "german", "hindi")
TOL = 1e-6


def _close(got, want, path="report"):
    """Nested dicts / lists equal in structure, numbers within TOL."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= TOL * max(1.0, abs(want)), (path, got, want)
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    """JAX-saved random adapters (r=4, alpha=8, q/v; english and german
    independent, hindi a rank-1 delta) -> {lang: (jax bank, lcfg, dir)}."""
    root = tmp_path_factory.mktemp("adapters")
    lcfg = jlora.LoraConfig(r=4, alpha=8, dropout=0.0)
    out = {}
    for i, lang in enumerate(LANGS):
        b = jlora.init_lora(jax.random.PRNGKey(i), CFG, lcfg)
        leaves, td = jax.tree.flatten(b)
        keys = jax.random.split(jax.random.PRNGKey(10 + i), len(leaves))
        new = [np.array(jax.random.normal(k, l.shape) * 0.1) for k, l in zip(keys, leaves)]
        if lang == "hindi":                # a [L, 1, d, r], b [L, 1, r, d]: rank 1
            for x in new:
                if x.shape[-1] == lcfg.r:
                    x[..., 1:] = 0.0
                else:
                    x[..., 1:, :] = 0.0
        b = jax.tree.unflatten(td, new)
        jlora.save_adapter(root / lang, b, lcfg, metadata={"language": lang})
        out[lang] = (b, lcfg, str(root / lang))
    return out


@pytest.mark.parametrize("lang", LANGS)
def test_analyze_adapter_equals_jax(banks, lang):
    b, lcfg, path = banks[lang]
    want = janalysis.analyze_adapter(b, lcfg)
    tb, tcfg, _ = tlora.load_adapter(path)
    got = tanalysis.analyze_adapter(tb, tcfg)
    _close(got, want)
    assert set(got["layers"]) == {"encoder.q", "encoder.v", "decoder.self_q",
                                  "decoder.self_v", "decoder.cross_q", "decoder.cross_v"}
    if lang == "hindi":
        assert all(r["effective_rank"] == pytest.approx(1.0, abs=1e-3)
                   for rows in got["layers"].values() for r in rows)
    # The same from a bank of numpy leaves.
    _close(tanalysis.analyze_adapter(tconvert.to_jax_params(tb), tcfg), want)


def test_effective_rank_and_singular_values_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 4)).astype(np.float32)
    b = rng.standard_normal((4, 16)).astype(np.float32)
    a[:, 1:] = 0.0
    b[1:] = 0.0
    sv = tadapters._delta_singular_values(a, b, 2.0)
    np.testing.assert_allclose(sv, jadapters._delta_singular_values(a, b, 2.0), atol=TOL)
    assert tadapters._effective_rank(sv) == pytest.approx(1.0, abs=1e-3)
    assert tadapters._effective_rank(np.zeros(4)) == jadapters._effective_rank(np.zeros(4))


@pytest.mark.parametrize("pair", [("english", "english"), ("english", "german"),
                                  ("german", "hindi")])
def test_adapter_similarity_equals_jax(banks, pair):
    (ja, la, pa), (jb, lb, pb) = banks[pair[0]], banks[pair[1]]
    want = janalysis.adapter_similarity(ja, jb, la.scale, lb.scale)
    ta, tb = tlora.load_adapter(pa)[0], tlora.load_adapter(pb)[0]
    got = tanalysis.adapter_similarity(ta, tb, la.scale, lb.scale)
    _close(got, want)
    if pair[0] == pair[1]:
        assert got["mean_similarity"] == pytest.approx(1.0, abs=1e-5)


def test_compare_adapters_and_cli_equal_jax(banks, tmp_path, capsys):
    dirs = {lang: path for lang, (_, _, path) in banks.items()}
    want = janalysis.compare_adapters(dirs)
    _close(tanalysis.compare_adapters(dirs), want)
    assert set(want["pairwise_similarity"]) == {"english/german", "english/hindi",
                                                "german/hindi"}
    argv = ["--adapters", *[f"{l}={p}" for l, p in dirs.items()], "--top_k", "3"]
    capsys.readouterr()
    jax_analyze_adapters.main(argv + ["--output", str(tmp_path / "jax.json")])
    jax_out = capsys.readouterr().out
    report = analyze_adapters.main(argv + ["--output", str(tmp_path / "sub" / "port.json")])
    assert capsys.readouterr().out == jax_out
    _close(json.loads((tmp_path / "sub" / "port.json").read_text()),
           json.loads((tmp_path / "jax.json").read_text()))
    _close(report, want)


def test_compare_adapters_over_peft_dirs_equals_jax(tmp_path):
    hf_cfg = tiny_hf_config(vocab_size=120, eos=3, sot=4)
    dirs = {}
    for i, lang in enumerate(("english", "german")):
        pm = peft_wrap(make_tiny_model(hf_cfg, seed=i))
        randomize_peft_lora(pm, seed=i)
        pm.save_pretrained(str(tmp_path / lang))
        dirs[lang] = str(tmp_path / lang)
    # A sar_tpu_torch-saved adapter beside them.
    tcfg = tconvert.config_from_hf(hf_cfg)
    bank, lcfg = tconvert.lora_from_peft(dirs["english"], tcfg)
    tlora.save_adapter(tmp_path / "ours", tconvert.from_jax_params(bank), lcfg)
    dirs["hindi"] = str(tmp_path / "ours")
    want = janalysis.compare_adapters(dirs, model=jconvert.config_from_hf(hf_cfg))
    got = tanalysis.compare_adapters(dirs, model=tcfg)
    _close(got, want)
    assert got["adapters"]["english"]["rank"] == 4
    assert got["pairwise_similarity"]["english/hindi"] == pytest.approx(1.0, abs=1e-5)
    with pytest.raises(ValueError, match="cannot infer the base model"):
        tanalysis.compare_adapters({"english": dirs["english"]})
    assert torch.is_tensor(tlora.load_adapter(dirs["hindi"])[0]["encoder"]["q"]["a"])
