"""The port's train CLI (python -m sar_tpu_torch.scripts.train_lora) end to
end on the CPU: whisper-test, the synthetic source, --device cpu; it writes
config.yaml, best/, step_N/, final/ and history.json, resumes from a
checkpoint, and refuses the flags it does not have with a message."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from sar_tpu_torch.models import lora as tlora
from sar_tpu_torch.scripts import train_lora

REPO = Path(__file__).resolve().parents[1]
FLAGS = {"--model": "whisper-test", "--language": "english", "--data_sources": "synthetic",
         "--lora_rank": "4", "--lora_alpha": "8", "--batch_size": "4",
         "--gradient_accumulation_steps": "2", "--learning_rate": "3e-3",
         "--warmup_steps": "1", "--max_steps": "4", "--eval_steps": "2",
         "--save_steps": "2", "--max_label_length": "16", "--max_new_tokens": "6",
         "--mixed_precision": "no", "--max_samples": "24", "--device": "cpu"}


def _argv(**over):
    flags = dict(FLAGS, **{f"--{k}": str(v) for k, v in over.items()})
    return [a for kv in flags.items() for a in kv] + ["--no_wandb"]


def test_train_cli_end_to_end(tmp_path):
    out = tmp_path / "run"
    proc = subprocess.run([sys.executable, "-m", "sar_tpu_torch.scripts.train_lora",
                           *_argv(output_dir=out)], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "train=24 validation=2 samples" in proc.stderr
    config = (out / "config.yaml").read_text()
    assert 'device: "cpu"' in config and "max_steps: 4" in config
    hist = json.loads((out / "history.json").read_text())
    assert len(hist["loss"]) == 4 and [e["step"] for e in hist["eval"]] == [0, 2, 4]
    assert all(e["num_samples"] == 2 for e in hist["eval"])
    for d in ("best/adapter", "step_2/adapter", "step_4/adapter", "final"):
        assert (out / d / "adapter_params.npz").exists(), d
    bank, lcfg, meta = tlora.load_adapter(out / "final")
    assert (lcfg.r, lcfg.alpha, meta["global_step"]) == (4, 8, 4)
    # Resume: the checkpoint's step comes back and training continues to 6.
    hist2 = train_lora.main(_argv(max_steps=6, eval_steps=0, save_steps=0,
                                  output_dir=tmp_path / "resumed",
                                  resume_from=out / "step_4"))
    assert len(hist2["loss"]) == 2


@pytest.mark.parametrize("flags,message", [
    (["--dp", "2"], "device meshes"), (["--tp", "2"], "device meshes"),
    (["--dcn_dp", "2"], "device meshes"), (["--platform", "cpu"], "--device"),
    (["--num_workers", "4"], "worker pools"), (["--cache_dir", "/x"], "weights"),
    (["--data_sources", "common_voice"], "synthetic")])
def test_train_cli_refuses_what_is_not_ported(tmp_path, capsys, flags, message):
    with pytest.raises(SystemExit) as e:
        train_lora.parse_args([*_argv(output_dir=tmp_path), *flags])
    assert e.value.code == 2
    assert message in capsys.readouterr().err
