"""Telegram bot frontend: style transfer of a two-photo album.

The port of the JAX package's ``frontends/tlbot.py`` (reference tlbot.py):
/start greets and explains (tlbot.py:91-102); an album (media group) must
contain exactly two photos — first = content, second = style
(tlbot.py:110-156); photos are downloaded, decoded, normalized and
enqueued (tlbot.py:122-151); progress photos are sent every >=20% and
"Done!" at completion, after which the task entry is removed
(tlbot.py:52-85); any other message is answered with a usage prompt
(tlbot.py:163-165).

The transport is the JAX package's minimal Telegram Bot API client over
aiohttp (the reference used aiogram): long-polling getUpdates,
media-group debouncing (Telegram delivers album photos as separate
messages sharing a media_group_id), getFile/download, and multipart
sendPhoto. The token comes from ASTT_TELEGRAM_TOKEN or --token:

  python -m artstyletransfer_tpu_torch.frontends.tlbot [--device cpu]

In this package jobs run on CUDA unless --device cpu (device='cpu'), and
without a card the entry points raise. The default executor
(--online-batching) is runtime/online.py's OnlineBatchingExecutor; the
serving mesh and the compilation cache of the JAX package have no
counterpart (one card; the CUDA graphs live in the process, see
frontends/lab.py). aiohttp is imported inside TelegramClient's methods
and OpenCV inside utils/image.py's functions, so the handler logic runs
with a fake transport (tests) and without either package.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import html
import logging
import os
import sys
import traceback
import uuid
from typing import Dict, List, Optional

from ..config import Config, production_config, resolve_device
from ..engine.transfer import ContentStylePair
from ..runtime.executor import Executor
from ..utils.image import decode_image, encode_jpeg

logger = logging.getLogger(__name__)

USAGE_TEXT = ("To start a job please send me two pictures "
              "<i>in a single message</i> - one for the <b>content</b> "
              "and one for the <b>style</b>")

# How long to wait after the last album part before treating it as complete.
MEDIA_GROUP_DEBOUNCE_S = 1.0


class TelegramClient:
    """Minimal Telegram Bot API transport over aiohttp."""

    def __init__(self, token: str):
        self._token = token
        self._base = f"https://api.telegram.org/bot{token}"
        self._file_base = f"https://api.telegram.org/file/bot{token}"
        self._session = None

    async def _ensure_session(self):
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession()
        return self._session

    async def close(self):
        if self._session is not None:
            await self._session.close()

    async def call(self, method: str, **params) -> dict:
        session = await self._ensure_session()
        async with session.post(f"{self._base}/{method}",
                                json=params) as resp:
            data = await resp.json()
        if not data.get("ok"):
            raise RuntimeError(f"Telegram {method} failed: {data}")
        return data["result"]

    async def get_updates(self, offset: Optional[int], timeout: int = 30):
        return await self.call("getUpdates", offset=offset, timeout=timeout,
                               allowed_updates=["message"])

    async def send_message(self, chat_id: int, text: str):
        return await self.call("sendMessage", chat_id=chat_id, text=text,
                               parse_mode="HTML")

    async def send_photo(self, chat_id: int, jpeg_bytes: bytes,
                         caption: str, filename: str = "image.jpg"):
        import aiohttp

        session = await self._ensure_session()
        form = aiohttp.FormData()
        form.add_field("chat_id", str(chat_id))
        form.add_field("caption", caption)
        form.add_field("photo", jpeg_bytes, filename=filename,
                       content_type="image/jpeg")
        async with session.post(f"{self._base}/sendPhoto",
                                data=form) as resp:
            data = await resp.json()
        if not data.get("ok"):
            raise RuntimeError(f"Telegram sendPhoto failed: {data}")
        return data["result"]

    async def download_file(self, file_id: str) -> bytes:
        info = await self.call("getFile", file_id=file_id)
        session = await self._ensure_session()
        async with session.get(
                f"{self._file_base}/{info['file_path']}") as resp:
            return await resp.read()


class ChatProgress:
    """Per-task chat/progress record (reference tlbot.py:39-42)."""

    def __init__(self, chat_id: int):
        self.chat_id = chat_id
        self.progress = 0


class StyleTransferBot:
    """Handler logic, transport-agnostic (testable with a fake client)."""

    def __init__(self, client, config: Optional[Config] = None, engine=None,
                 canonicalize: bool = False, metrics=None,
                 online: bool = False, executor=None,
                 queue_retries: int = 0, retry_delay_s: float = 25.0,
                 device=None):
        self.client = client
        self.config = config or Config()
        # canonicalize=True crops/resizes incoming photos to the canonical
        # aspect buckets, so at most len(DEFAULT_ASPECT_BUCKETS) graphs are
        # captured per batch size (each new shape costs two eager
        # evaluations and a capture). Off by default for exact reference
        # aspect handling.
        self.canonicalize = canonicalize
        self.tasks_table: Dict[str, ChatProgress] = {}
        self.table_lock = asyncio.Lock()
        if executor is not None:
            self.executor = executor
        elif online:
            # live batching: concurrent album jobs whose canonical shapes
            # share a bucket run as one batch of lanes instead of
            # 2-at-a-time (runtime/online.py). The executor canonicalizes
            # at add_task, so the handler-level crop is redundant.
            from ..runtime.online import OnlineBatchingExecutor

            self.canonicalize = False
            self.executor = OnlineBatchingExecutor(
                self.config, report_progress=self.task_progress_callback,
                report_failure=self.task_failed_callback,
                verbose=False, metrics=metrics, retries=queue_retries,
                retry_delay_s=retry_delay_s, device=device)
        else:
            self.executor = Executor(
                self.config, report_progress=self.task_progress_callback,
                report_failure=self.task_failed_callback,
                engine=engine, verbose=False, metrics=metrics,
                device=device)
        self._pending_albums: Dict[str, List[dict]] = {}
        self._album_timers: Dict[str, asyncio.TimerHandle] = {}

    # -- progress reporting (reference tlbot.py:52-85) ----------------------

    async def task_progress_callback(self, task_id: str, result):
        try:
            percent, img = result
            async with self.table_lock:
                if task_id not in self.tasks_table:
                    return
                chat_id = self.tasks_table[task_id].chat_id
                old_percent = self.tasks_table[task_id].progress

            if percent - old_percent >= 20 or percent >= 100:
                caption = ("Done!" if percent >= 100
                           else f"Progress: {percent:.1f}%")
                try:
                    await self.client.send_photo(
                        chat_id, encode_jpeg(img),
                        caption, filename=f"image_{percent:.1f}.jpg")
                except Exception:  # noqa: BLE001 — transport error
                    # one failed send (network blip, user blocked the bot)
                    # must not kill the optimization job, and under online
                    # batching it would fail the whole coalesced batch.
                    # Skip the update; progress stays at old_percent so the
                    # next chunk retries the send. A failed terminal send
                    # still releases the table entry (the job is over).
                    traceback.print_exc()
                    if percent >= 100:
                        async with self.table_lock:
                            self.tasks_table.pop(task_id, None)
                    return
                async with self.table_lock:
                    if task_id in self.tasks_table:
                        self.tasks_table[task_id].progress = percent

            async with self.table_lock:
                if percent >= 100:
                    self.tasks_table.pop(task_id, None)
        except Exception:
            traceback.print_exc()
            raise

    async def task_failed_callback(self, task_id: str, error: BaseException):
        """Tell the chat its job died and release the table entry — the
        reference leaves the user waiting forever (its failed task stays in
        tasks_table with no message, reference tlbot.py:83-85 only covers
        handler-level errors)."""
        async with self.table_lock:
            cp = self.tasks_table.pop(task_id, None)
        if cp is None:
            return
        try:
            await self.client.send_message(
                cp.chat_id,
                "Sorry, something went wrong while processing your images. "
                "Please try again.")
        except Exception:  # noqa: BLE001 — best-effort apology
            traceback.print_exc()

    # -- message handlers ----------------------------------------------------

    async def handle_message(self, message: dict):
        text = message.get("text", "")
        group_id = message.get("media_group_id")
        if group_id and message.get("photo"):
            self._collect_album_part(group_id, message)
        elif text.startswith("/start"):
            await self.handle_start(message)
        else:
            await self.respond_usage(message["chat"]["id"])

    async def handle_start(self, message: dict):
        # escape: the message is parse_mode=HTML and first_name is
        # user-controlled — an unescaped '<' would 400 the sendMessage
        name = html.escape(message.get("from", {}).get("first_name", "there"))
        await self.client.send_message(
            message["chat"]["id"],
            f"Hello, <b>{name}</b>! {USAGE_TEXT}")

    async def respond_usage(self, chat_id: int):
        await self.client.send_message(chat_id, USAGE_TEXT)

    def _collect_album_part(self, group_id: str, message: dict):
        """Debounce album parts: Telegram sends each album photo as its own
        message sharing media_group_id; fire the handler when no new part
        arrives for MEDIA_GROUP_DEBOUNCE_S."""
        self._pending_albums.setdefault(group_id, []).append(message)
        loop = asyncio.get_running_loop()
        old = self._album_timers.pop(group_id, None)
        if old is not None:
            old.cancel()
        self._album_timers[group_id] = loop.call_later(
            MEDIA_GROUP_DEBOUNCE_S,
            lambda: asyncio.ensure_future(self._flush_album(group_id)))

    async def _flush_album(self, group_id: str):
        messages = self._pending_albums.pop(group_id, [])
        self._album_timers.pop(group_id, None)
        if messages:
            await self.album_handler(messages)

    async def album_handler(self, messages: List[dict]):
        """Two photos in one album -> content + style job
        (reference tlbot.py:110-156)."""
        chat_id = messages[-1]["chat"]["id"]
        try:
            photos = [m for m in messages if m.get("photo")]
            if len(messages) != 2 or len(photos) != 2:
                await self.respond_usage(chat_id)
                return

            images = []
            for message in photos:
                # highest-resolution rendition is last (Bot API contract)
                file_id = message["photo"][-1]["file_id"]
                data = await self.client.download_file(file_id)
                images.append(decode_image(data))

            content_img, style_img = images
            if self.canonicalize:
                from ..parallel.batch import (canonicalize_content,
                                              canonicalize_style)

                content_img = canonicalize_content(content_img, self.config)
                style_img = canonicalize_style(style_img, self.config)
            task_id = str(uuid.uuid4())
            async with self.table_lock:
                if messages[0]["chat"]["id"] != messages[1]["chat"]["id"]:
                    raise ValueError("album parts from different chats")
                self.tasks_table[task_id] = ChatProgress(chat_id)
            await self.client.send_message(
                chat_id, "Processing has started. Please, wait...")
            await self.executor.add_task(
                task_id,
                ContentStylePair(("content.jpg", content_img),
                                 ("style.jpg", style_img)))
        except Exception:
            traceback.print_exc()
            await self.client.send_message(
                chat_id, "Oops... Something went wrong on the server. "
                         "Please ask the developer to check the logs")

    # -- polling loop ---------------------------------------------------------

    async def run_polling(self):
        runner = asyncio.create_task(self.executor.run(forever=True))
        offset = None
        try:
            while True:
                try:
                    updates = await self.client.get_updates(offset)
                except Exception as e:
                    logger.warning("getUpdates failed: %s", e)
                    await asyncio.sleep(3)
                    continue
                for update in updates:
                    offset = update["update_id"] + 1
                    message = update.get("message")
                    if message:
                        try:
                            await self.handle_message(message)
                        except Exception:
                            # one malformed message must not kill the bot
                            logger.exception("handle_message failed for "
                                             "update %s", update["update_id"])
        finally:
            runner.cancel()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m artstyletransfer_tpu_torch.frontends.tlbot",
        description="Telegram bot: style transfer of a two-photo album, "
                    "served on CUDA")
    parser.add_argument("--token", default=os.environ.get(
        "ASTT_TELEGRAM_TOKEN"))
    parser.add_argument("--canonicalize", action="store_true",
                        help="crop/resize incoming photos to the canonical "
                             "aspect buckets, so that at most one graph per "
                             "bucket and batch size is ever captured")
    parser.add_argument("--warmup", action="store_true",
                        help="capture every aspect bucket's evaluation as a "
                             "CUDA graph before polling (implies "
                             "--canonicalize), so that the first users "
                             "capture nothing; with --online-batching at "
                             "every batch size online rounds dispatch")
    parser.add_argument("--online-batching",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="coalesce concurrent jobs sharing a canonical "
                             "shape bucket into one batch of lanes (implies "
                             "canonicalization inside the executor); for "
                             "'batched'-policy configs (Adam, unit-opening "
                             "L-BFGS) arrivals join the in-flight batch at "
                             "the next chunk boundary. Default on; "
                             "--no-online-batching restores the "
                             "reference-style 2-at-a-time executor")
    parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                        default=None,
                        help="conv compute dtype; default: float32, which "
                             "production_config keeps")
    parser.add_argument("--stop-tol", type=float, default=None,
                        help="convergence early-stop for every served job: "
                             "end a run once the relative loss change over "
                             "a chunk is <= this (e.g. 1e-4; default: run "
                             "the full iteration budget like the reference)")
    parser.add_argument("--stop-shrink",
                        action=argparse.BooleanOptionalAction, default=None,
                        help="with --stop-tol: converged jobs leave their "
                             "batch individually (default on); "
                             "--no-stop-shrink stops a batch only when "
                             "every job in it converged")
    parser.add_argument("--metrics", default=None, metavar="PATH",
                        help="append structured per-progress JSONL metrics "
                             "to PATH")
    parser.add_argument("--retries", type=int, default=0, metavar="N",
                        help="re-run a failed online round or live bucket "
                             "up to N extra times, each retry_delay_s "
                             "(25 s) after the failure; only with "
                             "--online-batching")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device to serve on (default cuda; raises if "
                             "no card is visible)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: fail first
    if not args.token:
        print("Set ASTT_TELEGRAM_TOKEN or pass --token "
              "(get one via https://t.me/BotFather)", file=sys.stderr)
        return 1
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    cfg = production_config(Config(), device=args.device)
    if args.compute_dtype is not None:
        # an explicit dtype changes that field only; the other production
        # settings stand
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    if args.stop_tol is not None:
        cfg = dataclasses.replace(cfg, stop_tol=args.stop_tol)
    if args.stop_shrink is not None:
        cfg = dataclasses.replace(cfg, stop_shrink=args.stop_shrink)
    if args.warmup:
        from ..engine.warmup import warmup_serving

        # online serving always dispatches through BatchedTransferJob (a
        # graph of its own, even at one lane): warmup_serving captures
        # every size online rounds can dispatch
        warmup_serving(cfg, online=args.online_batching, device=args.device)
    metrics = None
    if args.metrics:
        from ..utils.metrics import MetricsLogger

        metrics = MetricsLogger(args.metrics)
    try:
        bot = StyleTransferBot(TelegramClient(args.token), cfg,
                               canonicalize=args.canonicalize or args.warmup,
                               metrics=metrics,
                               online=args.online_batching,
                               queue_retries=args.retries,
                               device=args.device)
        asyncio.run(bot.run_polling())
    finally:
        if metrics is not None:
            metrics.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
