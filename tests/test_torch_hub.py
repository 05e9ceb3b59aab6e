"""The port's hub interop (io/hub.py, cli/push.py) against a stubbed
``huggingface_hub``, as tests/test_hub.py holds mic_tpu's: local
directories pass through, repo ids route through snapshot_download,
failures raise mic_tpu's actionable errors, and push_to_hub calls the
upload API with the right arguments.  Nothing reaches the network.
"""

import sys
import types

import pytest

from mic_tpu.io import hub as jax_hub
from mic_tpu_torch.io import hub


def test_local_dir_passes_through(tmp_path):
    assert hub.resolve_model_dir(str(tmp_path)) == str(tmp_path)
    assert hub.is_local_dir(str(tmp_path)) and not hub.is_local_dir(str(tmp_path / "nope"))


def test_repo_id_routes_through_snapshot_download(tmp_path, monkeypatch):
    calls = {}

    def fake_snapshot_download(repo_id, revision=None, cache_dir=None, allow_patterns=None):
        calls.update(repo_id=repo_id, revision=revision, cache_dir=cache_dir,
                     allow_patterns=allow_patterns)
        return str(tmp_path / "snap")

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(snapshot_download=fake_snapshot_download))
    out = hub.resolve_model_dir("flax-community/some-model", revision="abc", cache_dir="c")
    assert out == str(tmp_path / "snap")
    assert (calls["repo_id"], calls["revision"], calls["cache_dir"]) == (
        "flax-community/some-model", "abc", "c")
    assert calls["allow_patterns"] == jax_hub._ALLOW_PATTERNS


def test_unresolvable_raises_actionable_error(monkeypatch):
    def boom(**kw):
        raise ConnectionError("no network")

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(snapshot_download=boom))
    with pytest.raises(FileNotFoundError, match="offline"):
        hub.resolve_model_dir("not/a-local-dir")


def test_missing_huggingface_hub_raises_actionable_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # import raises ImportError
    with pytest.raises(FileNotFoundError, match="huggingface_hub is unavailable"):
        hub.resolve_model_dir("not/a-local-dir")


class _FakeApi:
    seen: dict = {}

    def __init__(self, token=None):
        self.seen["token"] = token

    def create_repo(self, repo_id, private=False, exist_ok=False):
        self.seen["create"] = (repo_id, private, exist_ok)
        return f"https://hub/{repo_id}"

    def upload_folder(self, folder_path, repo_id, commit_message):
        self.seen["upload"] = (folder_path, repo_id, commit_message)


def test_push_to_hub_calls_upload(tmp_path, monkeypatch):
    (tmp_path / "config.json").write_text("{}")
    _FakeApi.seen = {}
    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(HfApi=_FakeApi))
    url = hub.push_to_hub(str(tmp_path), "me/model", private=True, commit_message="hi",
                          token="tok")
    assert url == "https://hub/me/model"
    assert _FakeApi.seen == {"token": "tok", "create": ("me/model", True, True),
                             "upload": (str(tmp_path), "me/model", "hi")}


def test_push_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        hub.push_to_hub(str(tmp_path / "nope"), "me/model")


def test_push_cli_and_captioner_push_to_hub(tmp_path, monkeypatch, capsys):
    """python -m mic_tpu_torch.cli.push takes mic_tpu's flags;
    Captioner.push_to_hub uploads a directory the same way."""
    from mic_tpu_torch.cli import push
    from mic_tpu_torch.core.config import CaptionerConfig
    from mic_tpu_torch.models.captioner import Captioner

    (tmp_path / "config.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(HfApi=_FakeApi))
    _FakeApi.seen = {}
    push.main(["--model_dir", str(tmp_path), "--repo_id", "me/cap", "--private",
               "--commit_message", "m", "--token", "t"])
    assert _FakeApi.seen["create"] == ("me/cap", True, True)
    assert _FakeApi.seen["upload"] == (str(tmp_path), "me/cap", "m")
    assert f"pushed {tmp_path} -> https://hub/me/cap" in capsys.readouterr().out
    _FakeApi.seen = {}
    url = Captioner(CaptionerConfig.tiny()).push_to_hub(str(tmp_path), "me/cap2")
    assert url == "https://hub/me/cap2"
    assert _FakeApi.seen["create"] == ("me/cap2", False, True)
    assert _FakeApi.seen["upload"] == (str(tmp_path), "me/cap2", "Upload mic_tpu model")
