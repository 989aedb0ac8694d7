"""sar_tpu_torch scaffold: configs equal to sar_tpu's, the weight bridge
round-trips bit-exactly, init/cast match the reference's shapes and dtypes,
and the package neither imports nor names jax or sar_tpu."""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_whisper, to_numpy, whisper_fields_equal

from sar_tpu.models import config as jcfg
from sar_tpu.models import whisper as jw
from sar_tpu_torch.models import config as tcfg
from sar_tpu_torch.models import whisper as tw
from sar_tpu_torch.models.convert import from_jax_params, to_jax_params

REPO = Path(__file__).resolve().parents[1]


# The port's registry holds the JAX package's configs and the OWSM ones,
# whose architecture (an E-Branchformer encoder) the JAX package lacks.
PORT_ONLY_CONFIGS = {"owsm-v4-medium", "owsm-test"}


@pytest.mark.parametrize("name", sorted(jcfg.MODEL_CONFIGS))
def test_model_configs_match_field_for_field(name):
    a, b = jcfg.MODEL_CONFIGS[name], tcfg.MODEL_CONFIGS[name]
    assert whisper_fields_equal(a, b)
    assert a.prompt_ids("hindi") == b.prompt_ids("hindi")
    assert a.num_audio_frames == b.num_audio_frames


def test_language_tables_match():
    assert tcfg.WHISPER_LANGUAGES == jcfg.WHISPER_LANGUAGES
    assert tcfg.LANGUAGE_CODES == jcfg.LANGUAGE_CODES
    assert tcfg.TARGET_LANGUAGES == jcfg.TARGET_LANGUAGES
    assert set(tcfg.MODEL_CONFIGS) == set(jcfg.MODEL_CONFIGS) | PORT_ONLY_CONFIGS


def _leaves(tree, path=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_param_bridge_round_trips_bit_exactly(dtype):
    cfg = jcfg.get_config("whisper-test")
    jp = to_numpy(jw.cast_params(
        jw.init_params(jax.random.PRNGKey(3), cfg), dtype))
    back = to_jax_params(from_jax_params(jp))
    want, got = list(_leaves(jp)), list(_leaves(back))
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_conv_weights_take_the_conv1d_layout():
    cfg = jcfg.get_config("whisper-test")
    jp, tp = jax_whisper(cfg)
    w = np.asarray(jp["encoder"]["conv1"]["w"])                # HIO [3, in, out]
    assert tuple(tp["encoder"]["conv1"]["w"].shape) == (cfg.d_model, cfg.num_mel_bins, 3)
    np.testing.assert_array_equal(tp["encoder"]["conv1"]["w"].numpy(),
                                  w.transpose(2, 1, 0))


def test_init_params_has_the_reference_shapes():
    cfg = jcfg.get_config("whisper-test")
    _, bridged = jax_whisper(cfg)
    own = tw.init_params(tcfg.get_config("whisper-test"),
                         torch.Generator().manual_seed(0))
    a, b = list(_leaves(bridged)), list(_leaves(own))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and y.dtype == torch.float32, path
    # Same scheme: N(0, 0.02) weights, zero biases, the sinusoid table.
    w = own["decoder"]["layers"]["fc1"]["w"]
    assert abs(float(w.std()) - 0.02) < 2e-3
    assert not own["decoder"]["layers"]["fc1"]["b"].any()
    np.testing.assert_array_equal(own["encoder"]["pos_embed"].numpy(),
                                  jw.sinusoids(cfg.max_source_positions, cfg.d_model))
    assert tw.param_count(own) == jw.param_count(
        jw.init_params(jax.random.PRNGKey(0), cfg))


def test_cast_params_keeps_layer_norms_fp32():
    cfg = tcfg.get_config("whisper-test")
    p = tw.cast_params(tw.init_params(cfg, torch.Generator().manual_seed(0)),
                       torch.bfloat16)
    assert p["encoder"]["layers"]["attn_ln"]["scale"].dtype == torch.float32
    assert p["decoder"]["ln"]["bias"].dtype == torch.float32
    assert p["decoder"]["layers"]["cross_q"]["w"].dtype == torch.bfloat16
    assert p["encoder"]["pos_embed"].dtype == torch.bfloat16
    f32 = p["decoder"]["token_embed_f32"]
    assert f32.dtype == torch.float32
    assert torch.equal(f32, p["decoder"]["token_embed"].float())
    # The fp32 logits copy is port-only: the bridge drops it.
    assert "token_embed_f32" not in to_jax_params(p)["decoder"]


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sar_tpu_torch\n"
        "for m in pkgutil.walk_packages(sar_tpu_torch.__path__, 'sar_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'sar_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('sar_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12      # every module was imported


def test_port_sources_never_name_jax_or_sar_tpu():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+sar_tpu\b(?!_torch)"
                         r"|from\s+sar_tpu\b(?!_torch))", re.MULTILINE)
    files = sorted((REPO / "sar_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
