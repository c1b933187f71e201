"""The port's CLI: index -> search -> query -> status -> projects ->
metadata -> settings through `lattice_tpu_torch.main.main()` on the
fixture repo, on the CPU (`--device cpu`), fully offline.

Mirror of `tests/test_cli.py` (the round trip, the incremental re-index,
`--batch-file` from a file, from stdin, missing and empty, `--deep`),
and against the JAX package's CLI: both index their own copy of the
fixture and give the same `search --json` output (names and order equal,
every other field equal, numbers within 1e-5), the same `--batch-file`
output, and the same parsed `settings` JSON for one env file. Then what
the port adds: without `--device` the device is "cuda", so without CUDA
`index` prints an error that names CUDA, returns 1 and writes no
`.lattice/`; `LATTICE_PLATFORM=cpu` asks for the CPU by name; `train`
over the persisted index (a TINY trainer) and `validate-weights` over a
small HF checkpoint print the reference's reports. `serve` runs
as a process on port 0 (`TestServeLifecycle`: a request, `--warmup`,
then SIGTERM and exit 0), and without `--device` `serve` and `mcp` exit
1 naming CUDA. `TestPersistentCompileCache` (XLA only) is not mirrored.
"""

import io
import json
import shutil

import pytest
import torch

from lattice_tpu import main as jax_cli
from lattice_tpu_torch import main as cli

QUERIES = ["who calls validate_email_format",
           "what is the class hierarchy of AdminUser",
           "what is AdminUser",
           "how are users created",
           "where is normalize_name defined",
           "what does create_user call"]
TOL = 1e-5


@pytest.fixture()
def repo(tmp_path, sample_project_path, monkeypatch):
    root = tmp_path / "proj"
    shutil.copytree(sample_project_path, root)
    # isolate the projects registry (both packages share its format)
    monkeypatch.setattr(cli, "PROJECTS_REGISTRY", tmp_path / "registry.json")
    monkeypatch.setattr(jax_cli, "PROJECTS_REGISTRY",
                        tmp_path / "jax_registry.json")
    # isolate settings: force hash provider + small dims via env file
    env = tmp_path / "cli.env"
    env.write_text(
        "EMBEDDING_PROVIDER=hash\nEMBEDDING_DIMENSIONS=128\n"
        "LATTICE_INDEX_DTYPE=float32\n")
    return root, env


def run(args, env, device="cpu"):
    head = ["--env", str(env)] + (["--device", device] if device else [])
    return cli.main(head + args)


def index(root, env, capsys, project="cli-test"):
    assert run(["index", str(root), "--project", project], env) == 0
    capsys.readouterr()


class TestCLIRoundtrip:
    def test_full_flow(self, repo, capsys):
        root, env = repo
        assert run(["index", str(root), "--project", "cli-test"], env) == 0
        out = capsys.readouterr().out
        assert "indexed cli-test" in out

        assert run(["search", "who calls validate_email_format",
                    "--path", str(root), "--json"], env) == 0
        results = json.loads(capsys.readouterr().out)
        names = [r["name"] for r in results]
        assert "app.services.user_service.UserService.create_user" in names

        assert run(["search", "who calls validate_email_format",
                    "--path", str(root)], env) == 0
        out = capsys.readouterr().out
        assert "intent: find_usage" in out and "create_user" in out

        assert run(["query", "what is the class hierarchy of AdminUser",
                    "--path", str(root)], env) == 0
        out = capsys.readouterr().out
        assert "BaseModel" in out

        assert run(["status", "--path", str(root)], env) == 0
        out = capsys.readouterr().out
        assert "project: cli-test" in out
        assert "graph:" in out
        assert "(128d, float32)" in out

        assert run(["projects", "list"], env) == 0
        out = capsys.readouterr().out
        assert "cli-test" in out

        assert run(["projects", "show", "cli-test"], env) == 0
        shown = json.loads(capsys.readouterr().out)
        assert shown["project"] == "cli-test" and shown["dtype"] == "float32"
        assert shown["file_hashes"] == 12

        assert run(["metadata", "show", "--path", str(root),
                    "--project", "cli-test"], env) == 0
        meta = json.loads(capsys.readouterr().out)
        assert meta["status"] in ("completed", "partial")

        assert run(["settings"], env) == 0
        dumped = json.loads(capsys.readouterr().out)
        assert dumped["ai"]["embedding_provider"] == "hash"

        assert run(["projects", "delete", "cli-test"], env) == 0
        assert not (root / ".lattice").exists()

    def test_search_without_index_errors(self, repo, tmp_path, capsys):
        _, env = repo
        empty = tmp_path / "empty"
        empty.mkdir()
        rc = run(["search", "anything", "--path", str(empty)], env)
        assert rc == 1
        err = capsys.readouterr().err
        assert "no index found" in err

    def test_incremental_reindex_skips(self, repo, capsys):
        root, env = repo
        index(root, env, capsys)
        assert run(["index", str(root), "--project", "cli-test"], env) == 0
        out = capsys.readouterr().out
        assert "indexed cli-test" in out

    def test_metadata_regenerate_adds_a_version(self, repo, capsys):
        root, env = repo
        index(root, env, capsys)
        assert run(["metadata", "regenerate", "--path", str(root),
                    "--project", "cli-test"], env) == 0
        assert json.loads(capsys.readouterr().out)["version"] == 2


class TestBatchFileSearch:
    def test_batch_file_ranks_each_query(self, repo, tmp_path, capsys):
        root, env = repo
        index(root, env, capsys)
        qfile = tmp_path / "queries.txt"
        qfile.write_text("who calls validate_email_format\n\n"
                         "what is AdminUser\n")
        assert run(["search", "--path", str(root), "--json",
                    "--batch-file", str(qfile)], env) == 0
        batch = json.loads(capsys.readouterr().out)
        assert [b["query"] for b in batch] == [
            "who calls validate_email_format", "what is AdminUser"]
        assert all(b["results"] for b in batch)
        assert all("intent" in b for b in batch)

    def test_batch_file_stdin(self, repo, capsys, monkeypatch):
        root, env = repo
        index(root, env, capsys)
        monkeypatch.setattr("sys.stdin", io.StringIO("what is AdminUser\n"))
        assert run(["search", "--path", str(root), "--json",
                    "--batch-file", "-"], env) == 0
        batch = json.loads(capsys.readouterr().out)
        assert len(batch) == 1 and batch[0]["results"]

    def test_batch_file_missing_is_a_clean_error(self, repo, tmp_path,
                                                 capsys):
        root, env = repo
        index(root, env, capsys)
        rc = run(["search", "--path", str(root),
                  "--batch-file", str(tmp_path / "nope.txt")], env)
        assert rc == 1
        assert "cannot read batch file" in capsys.readouterr().out

    def test_batch_file_empty_is_a_clean_error(self, repo, tmp_path,
                                               capsys):
        root, env = repo
        index(root, env, capsys)
        qfile = tmp_path / "empty.txt"
        qfile.write_text("\n\n")
        rc = run(["search", "--path", str(root),
                  "--batch-file", str(qfile)], env)
        assert rc == 1
        assert "no queries" in capsys.readouterr().out


class TestDeepSearchFlag:
    def test_search_deep_ranks_corpus_wide(self, repo, capsys):
        root, env = repo
        index(root, env, capsys)
        assert run(["search", "who calls validate_email_format",
                    "--path", str(root), "--deep", "--json"], env) == 0
        results = json.loads(capsys.readouterr().out)
        assert results
        names = [r["name"] for r in results]
        assert any("validate_email_format" in n for n in names)


def _same_json(a, b, where) -> None:
    """Equal structure and strings; numbers within TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same_json(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_json(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= TOL, (where, a, b)
    else:
        assert a == b, (where, a, b)


@pytest.fixture()
def both_indexed(repo, tmp_path, capsys):
    """The fixture indexed by each package's CLI, each into its own copy."""
    root, env = repo
    jroot = tmp_path / "jax_proj"
    shutil.copytree(root, jroot)
    index(root, env, capsys)
    assert jax_cli.main(["--env", str(env), "index", str(jroot),
                         "--project", "cli-test"]) == 0
    capsys.readouterr()
    return root, jroot, env


@pytest.mark.parametrize("deep", [False, True])
def test_search_json_matches_the_reference(both_indexed, capsys, deep):
    root, jroot, env = both_indexed
    flag = ["--deep"] if deep else []
    for text in QUERIES:
        assert run(["search", text, "--path", str(root), "--json"] + flag,
                   env) == 0
        mine = json.loads(capsys.readouterr().out)
        assert jax_cli.main(["--env", str(env), "search", text, "--path",
                             str(jroot), "--json"] + flag) == 0
        ref = json.loads(capsys.readouterr().out)
        assert mine, text
        assert [r["name"] for r in mine] == [r["name"] for r in ref], text
        _same_json(mine, ref, text)


def test_batch_file_json_matches_the_reference(both_indexed, tmp_path,
                                               capsys):
    root, jroot, env = both_indexed
    qfile = tmp_path / "q.txt"
    qfile.write_text("\n".join(QUERIES) + "\n")
    assert run(["search", "--path", str(root), "--json", "--batch-file",
                str(qfile)], env) == 0
    mine = json.loads(capsys.readouterr().out)
    assert jax_cli.main(["--env", str(env), "search", "--path", str(jroot),
                         "--json", "--batch-file", str(qfile)]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert [b["query"] for b in mine] == QUERIES
    _same_json(mine, ref, "batch")


@pytest.mark.parametrize("env_text", [
    "EMBEDDING_PROVIDER=hash\nEMBEDDING_DIMENSIONS=128\n"
    "LATTICE_INDEX_DTYPE=float32\n",
    "LATTICE_PLATFORM=cpu\nLLM_PROVIDER=ollama\nCHUNK_MAX_TOKENS=300\n"
    "LATTICE_DATA_DIR=.idx\nQUERY_SEARCH_LIMIT=7\n",
    ""])
def test_settings_json_matches_the_reference(tmp_path, capsys, env_text):
    env = tmp_path / "s.env"
    env.write_text(env_text)
    assert cli.main(["--env", str(env), "settings"]) == 0
    mine = json.loads(capsys.readouterr().out)
    assert jax_cli.main(["--env", str(env), "settings"]) == 0
    assert mine == json.loads(capsys.readouterr().out)


def test_default_device_is_cuda_and_writes_nothing(repo, capsys,
                                                   monkeypatch):
    root, env = repo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run(["index", str(root), "--project", "cli-test"], env,
               device=None) == 1
    err = capsys.readouterr().err
    assert err.startswith("error:") and "CUDA" in err
    assert not (root / ".lattice").exists()
    assert not cli.PROJECTS_REGISTRY.exists()
    # the query side too, over an index made on the CPU
    index(root, env, capsys)
    assert run(["search", "what is AdminUser", "--path", str(root)], env,
               device=None) == 1
    assert "CUDA" in capsys.readouterr().err


def test_lattice_platform_cpu_selects_the_cpu(repo, tmp_path, capsys,
                                              monkeypatch):
    root, env = repo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env.write_text(env.read_text() + "LATTICE_PLATFORM=cpu\n")
    assert run(["index", str(root), "--project", "cli-test"], env,
               device=None) == 0
    assert "indexed cli-test" in capsys.readouterr().out
    assert run(["search", "what is AdminUser", "--path", str(root),
                "--json"], env, device=None) == 0
    assert json.loads(capsys.readouterr().out)
    assert cli.resolve_device("cuda:0", cli.Settings.from_env(env)) == \
        "cuda:0"


@pytest.mark.parametrize("argv,item", [
    (["train"], "no index found"),
    (["validate-weights", "/nonexistent"], "not a directory"),
])
def test_commands_not_ported_exit_nonzero(repo, capsys, argv, item):
    """`train` and `validate-weights` are ported: with nothing to work on
    (no index under the path, no checkpoint dir) they exit 1 naming why,
    and never as "not ported"."""
    _, env = repo
    assert run(argv, env) == 1
    out = capsys.readouterr()
    assert "not ported" not in out.err + out.out
    assert item in (out.err if argv[0] == "train" else out.out)


TINY_TRAIN = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=4,
                  intermediate_size=64, max_position_embeddings=600,
                  dtype="float32")


@pytest.mark.parametrize("steps,batch", [(12, 4), (2, 64)])
def test_train_over_a_persisted_index(repo, capsys, monkeypatch, steps,
                                      batch):
    """`--device cpu train` over the persisted index (the trainer at
    `tests/test_finetune.py`'s TINY width): progress every 10 steps and at
    the end, then the reference's report; the checkpoint lands in the data
    dir, where the next command's encoder loads it. Fewer pairs than a
    batch: the "skipped" report, exit 0."""
    from lattice_tpu_torch.models import finetune
    from lattice_tpu_torch.models import unixcoder as um
    root, env = repo
    index(root, env, capsys)
    monkeypatch.setattr(finetune, "UniXcoderConfig",
                        lambda: um.UniXcoderConfig(**TINY_TRAIN))
    assert run(["train", "--path", str(root), "--steps", str(steps),
                "--batch-size", str(batch), "--lr", "1e-3"], env) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    ckpt = root / ".lattice" / "finetuned_params.npz"
    if batch > 26:
        assert report["status"] == "skipped" and not ckpt.exists()
        return
    assert [line.split(" loss=")[0] for line in out.splitlines()
            if line.startswith("step")] == ["step 10/12", "step 12/12"]
    assert set(report) == {"status", "pairs_mined", "steps", "batch_size",
                           "first_loss", "last_loss", "elapsed_s",
                           "checkpoint"}
    assert report["status"] == "completed" and report["steps"] == steps
    assert report["checkpoint"] == str(ckpt) and ckpt.is_file()
    model = um.UniXcoderModel(um.UniXcoderConfig(**TINY_TRAIN),
                              finetune_dir=root / ".lattice", device="cpu")
    assert model.loaded_finetuned


def test_validate_weights_over_a_checkpoint(tmp_path, capsys):
    """`--device cpu validate-weights <dir>` on a small HF checkpoint: exit
    0 and the reference's report (every check ok, parity with
    `transformers` where it imports, the tokenizer skipped without a
    vocab)."""
    transformers = pytest.importorskip("transformers")
    tcfg = transformers.RobertaConfig(
        vocab_size=512, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=256,
        max_position_embeddings=66, hidden_act="gelu",
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    ref = transformers.RobertaModel(tcfg, add_pooling_layer=False).eval()
    torch.save(ref.state_dict(), tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps(tcfg.to_dict()))
    assert cli.main(["--device", "cpu", "validate-weights",
                     str(tmp_path)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and set(report["checks"]) == {
        "dir", "state_dict", "param_mapping", "torch_parity", "tokenizer",
        "embedding_probe"}
    assert report["checks"]["torch_parity"]["ok"]
    assert report["checks"]["tokenizer"]["ok"] is None


@pytest.mark.parametrize("argv", [["serve", "--port", "0"], ["mcp"]],
                         ids=["serve", "mcp"])
def test_serve_and_mcp_default_to_cuda(repo, capsys, monkeypatch, argv):
    """Without `--device`, `serve` and `mcp` ask for "cuda", which raises
    without CUDA: `error: ...` naming CUDA and exit 1, before a socket
    opens or a request is read."""
    root, env = repo
    index(root, env, capsys)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run([*argv, "--path", str(root)], env, device=None) == 1
    err = capsys.readouterr().err
    assert err.startswith("error:") and "CUDA" in err


class TestServeLifecycle:
    """`lattice serve` as a process (mirror of `tests/test_cli.py`'s
    class): the printed line names the bound port, a request answers as
    the in-process engine's store does, `--warmup` flips `/healthz` warm,
    and SIGTERM drains and exits 0."""

    def test_sigterm_drains_and_exits_cleanly(self, repo, capsys):
        import os
        import signal
        import subprocess
        import sys
        import time
        import urllib.request

        root, env = repo
        index(root, env, capsys)
        proc = subprocess.Popen(
            [sys.executable, "-m", "lattice_tpu_torch.main", "--env",
             str(env), "--device", "cpu", "serve", "--path", str(root),
             "--port", "0", "--max-batch", "4", "--warmup"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(cli.Path(cli.__file__).resolve().parents[1]),
            env={**os.environ, "HOME": str(root.parent)})
        try:
            line = ""
            for _ in range(50):
                line = proc.stdout.readline()
                if "serving" in line and "http://" in line:
                    break
            assert "serving" in line and "http://" in line, line
            url = line.split("http://")[1].split()[0]
            assert not url.endswith(":0") and int(url.rsplit(":", 1)[1]) > 0

            def get(path):
                with urllib.request.urlopen(f"http://{url}{path}",
                                            timeout=30) as r:
                    return r.status, json.loads(r.read())
            deadline = time.monotonic() + 60
            status, body = get("/healthz")
            while status == 200 and not body["warm"] \
                    and time.monotonic() < deadline:
                time.sleep(0.1)
                status, body = get("/healthz")
            assert status == 200 and body["warm"], body
            req = urllib.request.Request(
                f"http://{url}/v1/search",
                data=json.dumps({"query": "what is AdminUser",
                                 "k": 3}).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200
                hits = json.loads(r.read())["hits"]
            engine, _ = cli._load_engine(root, cli.Settings.from_env(env),
                                         "cpu")
            vec = engine.vector_searcher.embedder.embed("what is AdminUser")
            want = engine.indexer.code.search(vec, 3)[0]
            assert [h["row"] for h in hits] == [r for r, _, _ in want]
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=60)
            assert proc.returncode == 0, out
            assert "shutting down" in out
        finally:
            if proc.poll() is None:
                proc.kill()
