"""The port's web lab and Telegram bot (frontends/lab.py, tlbot.py) on the
CPU, against the JAX package's.

The lab and bot tests of tests/test_frontends.py, mirrored on
device="cpu" with tests/astt_fakes.py's fake engine and transport; then
the two packages side by side: the same demo pairs and usage text, the
same routes, byte-equal pages for the same cards, the same bot
transcript for one scripted update sequence, and one real-engine lab run
in each (online executor, one Adam pair, one level at 16 px, seeded
weights): final images PSNR > 50 dB apart, final losses within rtol 1e-4
(the live runners' cross-package tolerance, tests/test_torch_live.py).
Both frontends import without aiohttp, jinja2 and OpenCV, and their mains
need CUDA unless given --device cpu.
"""

import asyncio
import filecmp
import importlib
import itertools
import json
import os
import sys
import uuid

import numpy as np
import pytest
import torch

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from artstyletransfer_tpu.config import Config as JConfig  # noqa: E402
from artstyletransfer_tpu.frontends import lab as jlab  # noqa: E402
from artstyletransfer_tpu.frontends import tlbot as jtlbot  # noqa: E402
from artstyletransfer_tpu.models import weights as jweights  # noqa: E402
from artstyletransfer_tpu.runtime import executor as jexecutor  # noqa: E402
from artstyletransfer_tpu_torch.config import Config  # noqa: E402
from artstyletransfer_tpu_torch.frontends import lab as tlab  # noqa: E402
from artstyletransfer_tpu_torch.frontends import tlbot as ttlbot  # noqa: E402
from artstyletransfer_tpu_torch.models import weights as tweights  # noqa: E402
from artstyletransfer_tpu_torch.runtime import executor as texecutor  # noqa: E402
from artstyletransfer_tpu_torch.utils.image import encode_jpeg  # noqa: E402

from astt_fakes import (FakeTelegramClient, _jpeg_bytes,  # noqa: E402
                        _photo_message, _write_demo_images, fake_engine)

CPU = dict(device="cpu")
SMALL_ADAM = dict(levels_num=1, iters_num=2, base_diameter=16,
                  optimizer="adam", stream_every=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_semaphores():
    for mod in (texecutor, jexecutor):
        mod.reset_semaphore()
    yield
    for mod in (texecutor, jexecutor):
        mod.reset_semaphore()


async def _wait_done(executor, n=1, polls=240, every=0.05):
    """Poll until n tasks exist and every one reached 100% (a fixed sleep
    flakes on a loaded host)."""
    for _ in range(polls):
        await asyncio.sleep(every)
        ids = await executor.task_ids()
        done = [(await executor.get_progress(i))[0] >= 100 for i in ids]
        if len(ids) >= n and all(done):
            return ids
    return await executor.task_ids()


def _serve(app, fn):
    """Run fn(client) against the app on a test server."""
    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await fn(client)
        finally:
            await client.close()

    return asyncio.run(go())


# ---------------------------------------------------------------------------
# the lab (tests/test_frontends.py, on the port)
# ---------------------------------------------------------------------------

def test_lab_routes(tmp_path):
    _write_demo_images(tmp_path)
    app = tlab.create_app(config=Config(iters_num=2), data_dir=str(tmp_path),
                          pairs=[("c.jpg", "s.jpg")], engine=fake_engine,
                          **CPU)

    async def go(client):
        ids = await _wait_done(app["executor"])
        resp = await client.get("/")
        assert resp.status == 200
        assert "job(s)" in await resp.text()
        assert len(ids) == 1
        resp = await client.get(f"/generated/{ids[0]}")
        assert resp.status == 200
        assert (await resp.read())[:2] == b"\xff\xd8"  # JPEG magic
        resp = await client.get("/generated/nonexistent")
        assert resp.status == 404
        resp = await client.get("/gallery")
        assert resp.status == 200
        assert "completed transfer" in await resp.text()

    _serve(app, go)


def test_lab_batched_mode(tmp_path):
    """The --batched lab path runs the demo through run_job_queue."""
    _write_demo_images(tmp_path)
    app = tlab.create_app(config=Config(**SMALL_ADAM), data_dir=str(tmp_path),
                          pairs=[("c.jpg", "s.jpg"), ("c.jpg", "s.jpg")],
                          batched=True, **CPU)

    async def go(client):
        ids = await _wait_done(app["executor"], n=2, polls=240, every=0.25)
        assert len(ids) == 2
        for i in ids:
            pct, img = await app["executor"].get_progress(i)
            assert pct == 100.0 and img is not None
        resp = await client.get(f"/generated/{ids[0]}")
        assert resp.status == 200
        assert (await resp.read())[:2] == b"\xff\xd8"

    _serve(app, go)


def test_lab_batched_failure_renders_error_state(tmp_path):
    """A failed batched job renders a FAILED card, not a stuck bar."""
    _write_demo_images(tmp_path)
    app = tlab.create_app(config=Config(**SMALL_ADAM), data_dir=str(tmp_path),
                          pairs=[("c.jpg", "s.jpg")], batched=True, **CPU)

    async def go(client):
        ids = await _wait_done(app["executor"], polls=240, every=0.25)
        # poison the record as if the bucket had failed (run_job_queue's
        # failure contract)
        app["executor"].failures[ids[0]] = RuntimeError("boom at 2K")
        resp = await client.get("/")
        assert resp.status == 200
        html = await resp.text()
        assert "FAILED" in html and "RuntimeError: boom at 2K" in html

    _serve(app, go)


def test_lab_showcase_routes(tmp_path):
    """/showcase and /showcase/levels, the files they link, and traversal
    attempts rejected."""
    _write_demo_images(tmp_path)
    import cv2

    results = tmp_path / "results"
    results.mkdir()
    img = (np.random.default_rng(1).random((8, 8, 3)) * 255).astype("uint8")
    for k in (1, 2):
        cv2.imwrite(str(results / f"bird_vg_lvl{k}.jpg"), img)
    app = tlab.create_app(config=Config(iters_num=2), data_dir=str(tmp_path),
                          pairs=[], engine=fake_engine, autostart=False,
                          results_dir=str(results), **CPU)

    async def go(client):
        resp = await client.get("/showcase")
        assert resp.status == 200
        html = await resp.text()
        assert "c.jpg" in html and "s.jpg" in html
        resp = await client.get("/data/content-images/c.jpg")
        assert resp.status == 200
        assert (await resp.read())[:2] == b"\xff\xd8"
        resp = await client.get("/showcase/levels")
        assert resp.status == 200
        html = await resp.text()
        assert "bird_vg" in html and "bird_vg_lvl2.jpg" in html
        resp = await client.get("/results/bird_vg_lvl1.jpg")
        assert resp.status == 200
        for path in ("/data/content-images/..%2F..%2Fetc",
                     "/data/other/c.jpg", "/results/nonexistent.jpg"):
            resp = await client.get(path)
            assert resp.status == 404, path

    _serve(app, go)


def test_lab_metrics_jsonl(tmp_path):
    """The lab writes structured progress events when metrics_path is set."""
    _write_demo_images(tmp_path)
    mpath = tmp_path / "lab_metrics.jsonl"
    app = tlab.create_app(config=Config(iters_num=2), data_dir=str(tmp_path),
                          pairs=[("c.jpg", "s.jpg")], engine=fake_engine,
                          metrics_path=str(mpath), **CPU)

    async def go(client):
        await _wait_done(app["executor"])

    _serve(app, go)
    events = [json.loads(line) for line in mpath.read_text().splitlines()]
    assert any(e["event"] == "progress" and e["percent"] == 100.0
               for e in events)


def test_lab_load_failure_isolated_to_its_pair(tmp_path):
    """A missing image fails only its own card; the other pair runs."""
    _write_demo_images(tmp_path)
    lab = tlab.Lab(config=Config(iters_num=2), data_dir=str(tmp_path),
                   pairs=[("missing.jpg", "s.jpg"), ("c.jpg", "s.jpg")],
                   engine=fake_engine, **CPU)

    async def go():
        await lab.backend_task()
        await lab.executor.run()
        return await lab.index_cards()

    cards = asyncio.run(go())
    assert sorted(c["failed"] for c in cards) == [False, True]
    assert all(c["percent"] == 100.0 for c in cards if not c["failed"])


# ---------------------------------------------------------------------------
# the bot (tests/test_frontends.py, on the port)
# ---------------------------------------------------------------------------

def _bot(client, **kw):
    return ttlbot.StyleTransferBot(client, Config(iters_num=2),
                                   **{**dict(engine=fake_engine), **kw,
                                      **CPU})


def _album(bot, chat=42):
    return bot.album_handler([_photo_message(chat, "f1", "g1"),
                              _photo_message(chat, "f2", "g1")])


def _client_with_photos(cls=FakeTelegramClient):
    client = cls()
    client.files["f1"] = _jpeg_bytes()
    client.files["f2"] = _jpeg_bytes()
    return client


def test_bot_start_and_fallback():
    client = FakeTelegramClient()
    bot = _bot(client)

    async def go():
        await bot.handle_message({"chat": {"id": 7}, "text": "/start",
                                  "from": {"first_name": "Ada"}})
        await bot.handle_message({"chat": {"id": 7}, "text": "hello"})

    asyncio.run(go())
    assert "Ada" in client.messages[0][1]
    assert "content" in client.messages[1][1]


def test_bot_album_runs_job_and_reports():
    client = _client_with_photos()
    bot = _bot(client)

    async def go():
        await _album(bot)
        await bot.executor.run()
        await asyncio.sleep(0.05)

    asyncio.run(go())
    assert any("Processing has started" in t for _, t in client.messages)
    assert "Done!" in [c for _, c in client.photos]
    assert all(chat == 42 for chat, _ in client.photos)
    assert bot.tasks_table == {}  # cleaned up at 100%


def test_bot_rejects_wrong_album_size():
    client = _client_with_photos()
    bot = _bot(client)

    async def go():
        await bot.album_handler([_photo_message(9, "f1", "g2")])

    asyncio.run(go())
    assert any("two pictures" in t for _, t in client.messages)
    assert client.photos == []


class ScriptedClient(FakeTelegramClient):
    """getUpdates returns each batch of updates in turn, then ends the
    polling loop."""

    def __init__(self, batches):
        super().__init__()
        self.offsets = []
        self.batches = list(batches)

    async def get_updates(self, offset, timeout=30):
        self.offsets.append(offset)
        if self.batches:
            return self.batches.pop(0)
        raise asyncio.CancelledError  # end the loop


def _run_polling(bot):
    async def go():
        try:
            await bot.run_polling()
        except asyncio.CancelledError:
            pass

    asyncio.run(go())


def test_bot_polling_loop_dispatches_updates():
    """run_polling: getUpdates -> handler dispatch -> offset advance."""
    client = ScriptedClient([
        [{"update_id": 5, "message": {"chat": {"id": 1}, "text": "/start",
                                      "from": {"first_name": "Bo"}}}],
        [{"update_id": 6, "message": {"chat": {"id": 1}, "text": "hi"}}],
    ])
    bot = _bot(client)
    _run_polling(bot)
    assert client.offsets == [None, 6, 7]  # offset advances past each
    assert any("Bo" in t for _, t in client.messages)
    assert any("two pictures" in t for _, t in client.messages)


def test_bot_media_group_debounce(monkeypatch):
    client = _client_with_photos()
    bot = _bot(client)
    monkeypatch.setattr(ttlbot, "MEDIA_GROUP_DEBOUNCE_S", 0.05)

    async def go():
        await bot.handle_message(_photo_message(11, "f1", "album9"))
        await bot.handle_message(_photo_message(11, "f2", "album9"))
        await asyncio.sleep(0.15)  # debounce fires -> album handled
        await bot.executor.run()
        await asyncio.sleep(0.05)

    asyncio.run(go())
    assert any("Processing has started" in t for _, t in client.messages)
    assert any(c == "Done!" for _, c in client.photos)


def test_bot_apologizes_and_cleans_up_on_engine_failure():
    """A failed job notifies the chat and releases its table entry."""
    async def broken_engine(pair, *args, **kwargs):
        await asyncio.sleep(0)
        raise RuntimeError("engine exploded")
        yield  # pragma: no cover — async generator

    client = _client_with_photos()
    bot = _bot(client, engine=broken_engine)

    async def go():
        await _album(bot)
        await bot.executor.run()
        await asyncio.sleep(0.05)

    asyncio.run(go())
    assert any("went wrong" in t for chat, t in client.messages if chat == 42)
    assert bot.tasks_table == {}


def test_bot_survives_transient_send_failure():
    """One failed send_photo skips that update instead of killing the
    job; the run completes and the final photo is delivered."""
    class FlakyClient(FakeTelegramClient):
        def __init__(self):
            super().__init__()
            self.failures_left = 1

        async def send_photo(self, chat_id, jpeg_bytes, caption,
                             filename=None):
            if self.failures_left > 0:
                self.failures_left -= 1
                raise ConnectionError("telegram hiccup")
            await super().send_photo(chat_id, jpeg_bytes, caption,
                                     filename=filename)

    client = _client_with_photos(FlakyClient)
    bot = _bot(client)

    async def go():
        await _album(bot)
        await bot.executor.run()
        await asyncio.sleep(0.05)

    asyncio.run(go())
    assert bot.executor.failures == {}
    assert "Done!" in [c for _, c in client.photos]
    assert bot.tasks_table == {}


def test_bot_canonicalize_buckets_album_shapes():
    """--canonicalize collapses arbitrary photo shapes onto the canonical
    bucket shape before the job is enqueued."""
    from artstyletransfer_tpu_torch.parallel.batch import (
        DEFAULT_ASPECT_BUCKETS, bucket_content_shape)

    client = FakeTelegramClient()
    client.files["f1"] = encode_jpeg(
        np.random.default_rng(2).random((37, 55, 3)).astype(np.float32))
    client.files["f2"] = encode_jpeg(
        np.random.default_rng(3).random((41, 29, 3)).astype(np.float32))
    seen = {}

    async def shape_probe_engine(pair, *args, **kwargs):
        seen["content"] = pair.content[1].shape
        seen["style"] = pair.style[1].shape
        yield 100.0, np.full((8, 8, 3), 0.5, np.float32)

    cfg = Config(levels_num=1, base_diameter=16, iters_num=2)
    bot = ttlbot.StyleTransferBot(client, cfg, engine=shape_probe_engine,
                                  canonicalize=True, **CPU)

    async def go():
        await bot.album_handler([_photo_message(5, "f1", "g7"),
                                 _photo_message(5, "f2", "g7")])
        await bot.executor.run()
        await asyncio.sleep(0.05)

    asyncio.run(go())
    buckets = {bucket_content_shape(a, cfg) + (3,)
               for a in DEFAULT_ASPECT_BUCKETS}
    assert seen["content"] in buckets
    assert seen["style"] == (16, 16, 3)


def test_retries_and_their_delay_reach_every_executor(tmp_path,
                                                     monkeypatch):
    """queue_retries and retry_delay_s reach the lab's and the bot's
    online executors and the lab's --batched run_job_queue."""
    import artstyletransfer_tpu_torch.parallel as parallel_mod

    kw = dict(queue_retries=2, retry_delay_s=0.5, **CPU)
    lab = tlab.Lab(config=Config(iters_num=2), pairs=[], online=True, **kw)
    bot = ttlbot.StyleTransferBot(FakeTelegramClient(), Config(iters_num=2),
                                  online=True, **kw)
    for ex in (lab.executor, bot.executor):
        assert (ex.retries, ex.retry_delay_s) == (2, 0.5)
    seen = {}

    def fake_queue(jobs, cfg, **kwargs):
        seen.update(kwargs)
        return {}, {}

    monkeypatch.setattr(parallel_mod, "run_job_queue", fake_queue)
    _write_demo_images(tmp_path)
    lab = tlab.Lab(config=Config(iters_num=2), data_dir=str(tmp_path),
                   pairs=[("c.jpg", "s.jpg")], **kw)
    asyncio.run(lab.backend_task_batched())
    assert (seen["retries"], seen["retry_delay_s"]) == (2, 0.5)
    assert seen["device"].type == "cpu"


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

def test_demo_pairs_and_usage_text_match_jax():
    assert tlab.CONTENT_STYLE_FILENAME_PAIRS == \
        jlab.CONTENT_STYLE_FILENAME_PAIRS
    assert ttlbot.USAGE_TEXT == jtlbot.USAGE_TEXT
    assert ttlbot.MEDIA_GROUP_DEBOUNCE_S == jtlbot.MEDIA_GROUP_DEBOUNCE_S


def _routes(app):
    return sorted((r.method, r.resource.canonical)
                  for r in app.router.routes())


def test_routes_match_jax(tmp_path):
    kw = dict(data_dir=str(tmp_path), pairs=[], engine=fake_engine,
              autostart=False)
    ours = tlab.create_app(config=Config(iters_num=2), **kw, **CPU)
    theirs = jlab.create_app(config=JConfig(iters_num=2), **kw)
    assert _routes(ours) == _routes(theirs)
    assert ("GET", "/generated/{image_id}") in _routes(ours)


@pytest.fixture
def counted_uuids(monkeypatch):
    """uuid4 as a counter that restart() sets back, so that two apps name
    their tasks alike."""
    state = {}

    def restart():
        state["it"] = itertools.count()

    restart()
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(int=next(state["it"])))
    return restart


def test_templates_and_pages_match_jax(tmp_path, counted_uuids):
    """The templates are byte-equal copies, and both apps serve the same
    bytes for the same cards: done, failed and running ones."""
    names = sorted(os.listdir(jlab._TEMPLATE_DIR))
    assert names == sorted(os.listdir(tlab._TEMPLATE_DIR))
    for name in names:
        assert filecmp.cmp(os.path.join(jlab._TEMPLATE_DIR, name),
                           os.path.join(tlab._TEMPLATE_DIR, name),
                           shallow=False), name
    _write_demo_images(tmp_path)
    pairs = [("c.jpg", "s.jpg"), ("missing.jpg", "s.jpg"), ("c.jpg", "s.jpg")]
    pages = {}
    for pkg, create_app, cfg, kw in (
            ("jax", jlab.create_app, JConfig(iters_num=2), {}),
            ("port", tlab.create_app, Config(iters_num=2), CPU)):
        counted_uuids()
        app = create_app(config=cfg, data_dir=str(tmp_path), pairs=pairs,
                         engine=fake_engine, **kw)

        async def go(client, app=app):
            await _wait_done(app["executor"], n=3)
            # a running card beside the finished and failed ones
            await app["executor"].set_progress("running", (37.5, None))
            return [await (await client.get(p)).read()
                    for p in ("/", "/gallery", "/showcase",
                              "/showcase/levels")]

        pages[pkg] = _serve(app, go)
    assert b"FAILED" in pages["port"][0] and b"37.5%" in pages["port"][0]
    assert pages["port"] == pages["jax"]


def _scripted_transcript(bot):
    """One scripted update sequence through a bot: /start (with a name to
    escape), a text, an album, an album of one photo; then its jobs
    drain."""
    async def go():
        await bot.handle_message({"chat": {"id": 7}, "text": "/start",
                                  "from": {"first_name": "Ada <3"}})
        await bot.handle_message({"chat": {"id": 7}, "text": "hello"})
        await _album(bot, chat=7)
        await bot.album_handler([_photo_message(8, "f1", "g2")])
        await bot.executor.run()
        await asyncio.sleep(0.05)

    asyncio.run(go())
    return bot.client.messages, bot.client.photos


def test_bot_transcript_matches_jax():
    ours = _scripted_transcript(_bot(_client_with_photos()))
    theirs = _scripted_transcript(jtlbot.StyleTransferBot(
        _client_with_photos(), JConfig(iters_num=2), engine=fake_engine))
    assert ours == theirs
    messages, photos = ours
    assert [c for _chat, c in photos] == ["Progress: 50.0%", "Done!"]
    assert "Ada &lt;3" in messages[0][1]


def test_lab_real_engine_matches_jax(tmp_path, monkeypatch):
    """One real-engine lab run in each package, default online mode: one
    Adam pair at one level and 16 px on the seeded weights. The final
    progress images PSNR > 50 dB apart and the final losses within rtol
    1e-4."""
    monkeypatch.delenv("ASTT_VGG19_WEIGHTS", raising=False)
    for mod in (jweights, tweights):  # no weights cache: the seeded init
        monkeypatch.setattr(mod, "_CACHE_FILE", str(tmp_path / "none.npz"))
    _write_demo_images(tmp_path)
    out = {}
    for pkg, create_app, cfg, kw in (
            ("jax", jlab.create_app, JConfig(**SMALL_ADAM), {}),
            ("port", tlab.create_app, Config(**SMALL_ADAM), CPU)):
        mpath = tmp_path / f"{pkg}.jsonl"
        app = create_app(config=cfg, data_dir=str(tmp_path),
                         pairs=[("c.jpg", "s.jpg")], online=True,
                         metrics_path=str(mpath), **kw)

        async def go(client, app=app):
            ids = await _wait_done(app["executor"], polls=600, every=0.1)
            assert len(ids) == 1
            return await app["executor"].get_progress(ids[0])

        pct, img = _serve(app, go)
        events = [json.loads(line) for line in mpath.read_text().splitlines()]
        losses = [e["loss"] for e in events if e["event"] == "progress"]
        assert pct == 100.0 and img is not None and losses, pkg
        out[pkg] = (img, losses[-1])
    (img, loss), (ref_img, ref_loss) = out["port"], out["jax"]
    assert img.shape == ref_img.shape == (16, 16, 3)
    mse = float(np.mean((np.clip(img, 0, 1) - np.clip(ref_img, 0, 1)) ** 2))
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 50.0
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)


# ---------------------------------------------------------------------------
# imports and entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lab", "tlbot"])
def test_frontend_imports_without_aiohttp_jinja2_opencv(name, monkeypatch):
    """A fresh import of the module with aiohttp, jinja2 and cv2 blocked;
    the bot then answers /start through a fake transport."""
    import artstyletransfer_tpu_torch.frontends as pkg

    full = f"artstyletransfer_tpu_torch.frontends.{name}"
    for blocked in ("aiohttp", "jinja2", "cv2"):
        monkeypatch.setitem(sys.modules, blocked, None)
    monkeypatch.delitem(sys.modules, full)
    monkeypatch.setattr(pkg, name, getattr(pkg, name))
    mod = importlib.import_module(full)
    assert mod is not (tlab if name == "lab" else ttlbot)
    if name == "tlbot":
        client = FakeTelegramClient()
        bot = mod.StyleTransferBot(client, Config(iters_num=2),
                                   engine=fake_engine, **CPU)
        asyncio.run(bot.handle_message({"chat": {"id": 3},
                                        "text": "/start"}))
        assert "there" in client.messages[0][1]
    else:
        lab = mod.Lab(config=Config(iters_num=2), pairs=[],
                      engine=fake_engine, **CPU)
        assert asyncio.run(lab.index_cards()) == []


def test_lab_main_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlab.main(["--no-autostart"])
    served = []
    monkeypatch.setattr(aiohttp.web, "run_app",
                        lambda app, **kw: served.append((app, kw)))
    assert tlab.main(["--device", "cpu", "--no-autostart",
                      "--port", "0"]) == 0
    (app, kw), = served
    assert kw["port"] == 0 and app["lab"].device.type == "cpu"
    assert app["executor"].device.type == "cpu"  # --online by default


def test_tlbot_main_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttlbot.main(["--token", "t"])
    polled = []

    async def no_polling(bot):
        polled.append(bot.executor.device)

    monkeypatch.setattr(ttlbot.StyleTransferBot, "run_polling", no_polling)
    assert ttlbot.main(["--token", "t", "--device", "cpu"]) == 0
    assert [d.type for d in polled] == ["cpu"]
