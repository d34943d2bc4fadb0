"""PyTorch port, ``danet_tpu_torch/utils.py`` against ``danet_tpu/utils.py``:
the same ``input`` answers (monkeypatched) on the same existing and missing
files give the same returns, the same prompts and the same files."""
import builtins
import os

import pytest

pytest.importorskip("torch")

from danet_tpu import utils as jutils  # noqa: E402
from danet_tpu_torch import utils as tutils  # noqa: E402


def _run(mod, fn, arg, answers, monkeypatch):
    """(return, prompts asked) of ``mod.fn(arg)`` fed ``answers``."""
    asked, it = [], iter(answers)

    def fake_input(prompt=""):
        asked.append(prompt)
        return next(it)
    monkeypatch.setattr(builtins, "input", fake_input)
    return getattr(mod, fn)(arg), asked


@pytest.mark.parametrize("answers", [["Y"], ["n"], ["x", "y", "Y"],
                                     ["", "N", "n"]])
def test_torch_prompt_yesno_matches_jax(monkeypatch, answers):
    """prompt_yesno asks until 'Y' or 'n', with JAX's prompt text."""
    want = _run(jutils, "prompt_yesno", "go on?", answers, monkeypatch)
    got = _run(tutils, "prompt_yesno", "go on?", answers, monkeypatch)
    assert got == want


@pytest.mark.parametrize("exists,answers", [
    (False, []), (True, ["Y"]), (True, ["n"]), (True, ["q", "c"]),
    (True, ["c"])])
def test_torch_prompt_overwrite_matches_jax(tmp_path, monkeypatch, exists,
                                            answers):
    """prompt_overwrite on a missing file creates it and returns its name;
    on an existing one it returns it ('Y'), '' ('n') or the first free
    copy name, created ('c'; with file.0 already taken: file.1): the
    return, the prompts and the files left equal JAX's."""
    outs = []
    for mod, sub in ((jutils, "jax"), (tutils, "torch")):
        d = tmp_path / sub
        d.mkdir()
        name = str(d / "out.wav")
        if exists:
            (d / "out.wav").write_text("old")
            (d / "out.wav.0").write_text("taken")
        got, asked = _run(mod, "prompt_overwrite", name, answers,
                          monkeypatch)
        files = {p: (d / p).read_text() for p in sorted(os.listdir(d))}
        outs.append((os.path.basename(got) if got else got,
                     [a.replace(str(d), "<d>") for a in asked], files))
    assert outs[0] == outs[1]
    if not exists:
        assert outs[1][0] == "out.wav" and outs[1][2] == {"out.wav": ""}
