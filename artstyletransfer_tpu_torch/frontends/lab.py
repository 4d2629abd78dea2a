"""Web lab frontend: live progress grid for a batch of style-transfer jobs.

The port of the JAX package's ``frontends/lab.py`` (reference lab.py): on
startup a background task enqueues the demo content x style pairs
(reference lab.py:79-107); route ``/`` renders a progress-card page
(reference lab.py:125-142); route ``/generated/<id>`` serves the latest
intermediate image JPEG-encoded at quality 75 (reference lab.py:145-164);
the server binds 0.0.0.0:8080 (reference lab.py:167-168). The routes, the
demo pairs, the templates (frontends/templates, this package's own copy)
and the flags are the JAX package's:

  python -m artstyletransfer_tpu_torch.frontends.lab [--device cpu]

In this package:
- Jobs run on CUDA unless --device cpu (device='cpu'); without a card
  the entry points raise.
- The default executor (--online) is runtime/online.py's
  OnlineBatchingExecutor; --no-online runs the reference's 2-at-a-time
  Executor, and --batched one run_job_queue over the whole demo.
- On CUDA the online executor and --batched serve on
  default_serving_mesh(), as in the JAX package: every card of a host
  with two or more (parallel/mesh.py; ASTT_SERVING_MESH=none turns it
  off), one card otherwise.
- No compilation cache: the JAX package turns on XLA's persistent cache
  in main; here each evaluation is a CUDA graph captured in the process
  (engine/transfer.py's _COMPILE_CACHE), and --warmup captures the
  serving buckets' graphs before the server binds.
- The state and logic of the routes live in ``Lab``, plain code that
  ``create_app`` wraps in an aiohttp application. aiohttp and jinja2 are
  imported inside create_app, render and main, and OpenCV inside
  utils/image.py's functions, so the module imports, and a Lab serves,
  without any of them.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import functools
import os
import re
import uuid

from ..config import (PRESETS, STANDARD_GAUSS_NOISE_CONFIG, production_config,
                      resolve_device)
from ..engine.transfer import ContentStylePair
from ..parallel.mesh import serving_mesh
from ..runtime.executor import Executor, call_in_loop, record_failure
from ..utils.image import encode_jpeg, load_image

# The demo batch (reference lab.py:79-100).
CONTENT_STYLE_FILENAME_PAIRS = [
    ("bird.jpg", "cubism2.jpg"),
    ("bird.jpg", "matisse2.jpg"),
    ("bird.jpg", "expressive.jpg"),
    ("bird.jpg", "starry_night.jpg"),
    ("car.jpg", "mosaic.jpg"),
    ("car.jpg", "expressive.jpg"),
    ("car.jpg", "matisse2.jpg"),
    ("car.jpg", "cubism2.jpg"),
    ("columns.jpg", "cubism1.jpg"),
    ("columns.jpg", "cubism2.jpg"),
    ("columns.jpg", "cubism3.jpg"),
    ("columns.jpg", "matisse2.jpg"),
    ("girl_with_gun.jpg", "mona_lisa.jpg"),
    ("girl_with_gun.jpg", "mosaic.jpg"),
    ("girl_with_gun.jpg", "starry_night.jpg"),
    ("girl_with_gun.jpg", "cubism1.jpg"),
    ("lion.jpg", "mona_lisa.jpg"),
    ("lion.jpg", "mosaic.jpg"),
    ("lion.jpg", "starry_night.jpg"),
    ("lion.jpg", "cubism1.jpg"),
]

_TEMPLATE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "templates")


def default_data_dir() -> str:
    return os.environ.get(
        "ASTT_DATA_DIR",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "..", "..", "data"))


@functools.lru_cache(maxsize=1)
def _templates():
    import jinja2

    return jinja2.Environment(loader=jinja2.FileSystemLoader(_TEMPLATE_DIR),
                              autoescape=True)


def render(template: str, **context) -> str:
    """One of the lab's pages (frontends/templates) as HTML."""
    return _templates().get_template(template).render(**context)


class Lab:
    """The lab's state and the logic of its routes, without aiohttp.

    `engine`/`pairs`/`executor` are injectable for tests. The executor is
    made as the JAX package's create_app makes it: online=True serves
    through the online batching executor (tasks are canonicalized onto the
    aspect-bucket shapes, so output geometry follows the serving buckets),
    else the 2-at-a-time Executor. The demo goes in task by task
    (backend_task) or through one run_job_queue (backend_task_batched,
    the --batched mode). queue_retries re-runs a failed round or live
    bucket, retry_delay_s seconds after the failure."""

    def __init__(self, config=None, data_dir: str = None, pairs=None,
                 engine=None, online: bool = False,
                 executor=None, results_dir: str = None,
                 metrics_path: str = None, queue_retries: int = 0,
                 retry_delay_s: float = 25.0, device=None):
        if engine is not None and online and executor is None:
            raise ValueError("engine injection is not supported with "
                             "online=True (the online executor's unit of "
                             "execution is the batched queue; inject "
                             "executor= or queue_runner instead)")
        self.config = config or STANDARD_GAUSS_NOISE_CONFIG
        self.device = resolve_device(device)
        self.data_dir = data_dir or default_data_dir()
        self.results_dir = results_dir or os.environ.get(
            "ASTT_RESULTS_DIR", os.path.join(self.data_dir, "..", "results"))
        self.pairs = pairs if pairs is not None else CONTENT_STYLE_FILENAME_PAIRS
        self.queue_retries = queue_retries
        self.retry_delay_s = retry_delay_s
        self.metrics = None
        if metrics_path:
            from ..utils.metrics import MetricsLogger

            self.metrics = MetricsLogger(metrics_path)
        if executor is None:
            if online:
                from ..runtime.online import OnlineBatchingExecutor

                executor = OnlineBatchingExecutor(
                    self.config, verbose=False, metrics=self.metrics,
                    mesh=serving_mesh(self.device), retries=queue_retries,
                    retry_delay_s=retry_delay_s, device=self.device)
            else:
                executor = Executor(self.config, engine=engine,
                                    verbose=False, metrics=self.metrics,
                                    device=self.device)
        self.executor = executor

    # -- the demo batch ----------------------------------------------------

    def load_pairs(self):
        """[(c_name, content, s_name, style, error|None)]: a missing or
        corrupt image fails ONLY its pair (the task renders as a failed
        card) instead of killing the whole demo batch. The reference
        raises on the first missing file (reference lab.py:117-118)."""
        content_dir = os.path.join(self.data_dir, "content-images")
        style_dir = os.path.join(self.data_dir, "style-images")
        out = []
        for c_name, s_name in self.pairs:
            try:
                content = load_image(os.path.join(content_dir, c_name))
                style = load_image(os.path.join(style_dir, s_name))
                out.append((c_name, content, s_name, style, None))
            except Exception as e:  # noqa: BLE001 — per-pair isolation
                out.append((c_name, None, s_name, None, e))
        return out

    async def record_load_failure(self, task_id, error):
        # seed the progress table so the card exists, then mark it failed
        await self.executor.set_progress(task_id, (-1, None))
        record_failure(self.executor.failures, task_id, error)

    async def backend_task(self):
        """Enqueue every demo pair as its own task."""
        for c_name, content, s_name, style, err in self.load_pairs():
            if err is not None:
                await self.record_load_failure(str(uuid.uuid4()), err)
                continue
            await self.executor.add_task(
                str(uuid.uuid4()),
                ContentStylePair((c_name, content), (s_name, style)))

    async def backend_task_batched(self):
        """Run the whole demo through one run_job_queue (shape-bucketed
        batches of lanes), streaming progress into the same table."""
        from ..parallel import run_job_queue

        executor, metrics = self.executor, self.metrics
        jobs = []
        for _c, content, _s, style, err in self.load_pairs():
            if err is not None:
                await self.record_load_failure(str(uuid.uuid4()), err)
                continue
            jobs.append((str(uuid.uuid4()), content, style))
        loop = asyncio.get_running_loop()
        for tid, _c, _s in jobs:
            await executor.set_progress(tid, (-1, None))

        def report(tid, pct, img, loss):
            # the thread->loop hop drops the update when the server is
            # shutting down mid-batch instead of failing the whole bucket
            if not call_in_loop(loop, executor.set_progress(tid, (pct, img))):
                return
            if metrics is not None:
                # the batched queue bypasses Executor's own report, so emit
                # the structured progress event here (with the real loss)
                metrics.log("progress", task=tid, percent=pct, loss=loss)

        _results, failures = await loop.run_in_executor(
            None, lambda: run_job_queue(jobs, self.config, progress=report,
                                        mesh=serving_mesh(self.device),
                                        canonicalize_styles=True,
                                        retries=self.queue_retries,
                                        retry_delay_s=self.retry_delay_s,
                                        device=self.device))
        # a failed job renders as an error card, not a stuck progress bar
        for tid, exc in failures.items():
            record_failure(executor.failures, tid, exc)

    # -- what the routes show ----------------------------------------------

    async def index_cards(self):
        """The progress cards of `/`, one per task."""
        cards = []
        for image_id in await self.executor.task_ids():
            percent, _img = await self.executor.get_progress(image_id)
            percent = percent if percent > 0 else 0
            failure = self.executor.failures.get(image_id)
            cards.append({
                "image_id": image_id,
                "percent": percent,
                "cur_iter": percent / 100.0 * self.config.iters_num,
                "iters_num": self.config.iters_num,
                "failed": failure is not None,
                "error": (f"{type(failure).__name__}: {failure}"
                          if failure is not None else ""),
            })
        return cards

    async def gallery_cards(self):
        """Completed results (`/gallery`): the counterpart of the
        reference's static showcase pages (reference templates/
        img_table.html, img_table_lvls.html, which its app never routed)."""
        cards = []
        for image_id in await self.executor.task_ids():
            percent, _img = await self.executor.get_progress(image_id)
            if percent >= 100:
                cards.append({"image_id": image_id})
        return cards

    def showcase_listing(self):
        """(content names, style names) of the corpus grid (`/showcase`,
        reference templates/img_table.html)."""
        def listing(sub):
            d = os.path.join(self.data_dir, sub)
            if not os.path.isdir(d):
                return []
            return sorted(f for f in os.listdir(d)
                          if f.lower().endswith((".jpg", ".jpeg", ".png")))

        return listing("content-images"), listing("style-images")

    def level_groups(self):
        """Per-level result progressions (`/showcase/levels`, reference
        templates/img_table_lvls.html): <name>_lvl<k>.jpg files of the
        results directory grouped by name, levels in order."""
        groups = {}
        if os.path.isdir(self.results_dir):
            for f in sorted(os.listdir(self.results_dir)):
                m = re.match(r"(.+)_lvl(\d+)\.(jpg|jpeg|png)$", f)
                if m:
                    groups.setdefault(m.group(1), []).append(
                        (int(m.group(2)), f))
        return [{"name": k, "files": [f for _n, f in sorted(v)]}
                for k, v in sorted(groups.items())]

    @staticmethod
    def safe_file(root, name):
        """The file `name` inside `root`, or None for anything else (a
        missing file, a path that leaves root)."""
        path = os.path.realpath(os.path.join(root, name))
        if not path.startswith(os.path.realpath(root) + os.sep) \
                or not os.path.isfile(path):
            return None
        return path

    def data_file(self, sub, name):
        """A corpus image (`/data/{sub}/{name}`), or None."""
        if sub not in ("content-images", "style-images"):
            return None
        return self.safe_file(os.path.join(self.data_dir, sub), name)

    def result_file(self, name):
        """A rendered result (`/results/{name}`), or None."""
        return self.safe_file(self.results_dir, name)

    async def latest_jpeg(self, image_id):
        """The task's latest image as JPEG bytes (quality 75), None while it
        has none; KeyError for an unknown task (`/generated/{image_id}`)."""
        _percent, img = await self.executor.get_progress(image_id)
        if img is None:
            return None
        return encode_jpeg(img, quality=75)

    async def aclose(self):
        """Stop the executor's dispatcher where it has one, and close the
        metrics log."""
        aclose = getattr(self.executor, "aclose", None)
        if aclose is not None:
            await aclose()
        if self.metrics is not None:
            self.metrics.close()


def create_app(config=None, data_dir: str = None, pairs=None,
               autostart: bool = True, engine=None,
               batched: bool = False,
               online: bool = False,
               executor=None,
               results_dir: str = None,
               metrics_path: str = None,
               queue_retries: int = 0,
               retry_delay_s: float = 25.0,
               device=None):
    """The lab's aiohttp application around a Lab (same arguments; device
    None is CUDA). app["lab"] is the Lab, app["executor"] its executor."""
    from aiohttp import web

    lab = Lab(config=config, data_dir=data_dir, pairs=pairs, engine=engine,
              online=online, executor=executor,
              results_dir=results_dir, metrics_path=metrics_path,
              queue_retries=queue_retries, retry_delay_s=retry_delay_s,
              device=device)

    def page(template, **context):
        return web.Response(text=render(template, **context),
                            content_type="text/html")

    def file_or_404(path):
        if path is None:
            raise web.HTTPNotFound(text="No such file")
        return web.FileResponse(path)

    async def index(request: web.Request) -> web.Response:
        return page("index.html", cards=await lab.index_cards())

    async def gallery(request: web.Request) -> web.Response:
        return page("gallery.html", cards=await lab.gallery_cards())

    async def showcase(request: web.Request) -> web.Response:
        contents, styles = lab.showcase_listing()
        return page("showcase.html", contents=contents, styles=styles)

    async def showcase_levels(request: web.Request) -> web.Response:
        return page("showcase_levels.html", groups=lab.level_groups())

    async def serve_data(request: web.Request) -> web.FileResponse:
        return file_or_404(lab.data_file(request.match_info["sub"],
                                         request.match_info["name"]))

    async def serve_result(request: web.Request) -> web.FileResponse:
        return file_or_404(lab.result_file(request.match_info["name"]))

    async def serve_image(request: web.Request) -> web.Response:
        try:
            body = await lab.latest_jpeg(request.match_info["image_id"])
        except KeyError:
            raise web.HTTPNotFound(text="No such task")
        if body is None:
            return web.Response(text="No image yet")
        return web.Response(body=body, content_type="image/jpg")

    async def on_startup(app):
        if autostart:
            task_fn = (lab.backend_task_batched if batched
                       else lab.backend_task)
            app["backend"] = asyncio.create_task(task_fn())
        app["runner"] = asyncio.create_task(lab.executor.run(forever=True))

    async def on_cleanup(app):
        for key in ("backend", "runner"):
            task = app.get(key)
            if task is not None:
                task.cancel()
        await lab.aclose()

    app = web.Application()
    app["lab"] = lab
    app["executor"] = lab.executor
    app.router.add_get("/", index)
    app.router.add_get("/gallery", gallery)
    app.router.add_get("/showcase", showcase)
    app.router.add_get("/showcase/levels", showcase_levels)
    app.router.add_get("/data/{sub}/{name}", serve_data)
    app.router.add_get("/results/{name}", serve_result)
    app.router.add_get("/generated/{image_id}", serve_image)
    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m artstyletransfer_tpu_torch.frontends.lab",
        description="Web lab: a live progress grid of the demo batch, "
                    "served on CUDA")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--preset", choices=sorted(PRESETS),
                        default="standard")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--no-autostart", action="store_true",
                        help="do not enqueue the demo batch on startup")
    parser.add_argument("--max-pairs", type=int, default=None,
                        help="truncate the demo batch to the first N pairs "
                             "(rehearsals/smoke drives; default: all 20)")
    parser.add_argument("--batched", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="run the demo queue through the batched queue "
                             "path (one run_job_queue over the whole demo, "
                             "shape-bucketed batches of lanes; overrides "
                             "--online for the demo enqueue)")
    parser.add_argument("--online", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="serve live tasks through the online batching "
                             "executor: concurrent same-bucket jobs run as "
                             "one batch of lanes; for 'batched'-policy "
                             "configs (Adam, unit-opening L-BFGS) arrivals "
                             "join the in-flight batch at the next chunk "
                             "boundary (parallel/live.py), the others run "
                             "in rounds through run_job_queue. Default on; "
                             "--no-online restores the reference-style "
                             "2-at-a-time executor")
    parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                        default=None,
                        help="conv compute dtype; default: the preset's "
                             "(float32), which production_config keeps")
    parser.add_argument("--stop-tol", type=float, default=None,
                        help="convergence early-stop for every served job: "
                             "end a run once the relative loss change over "
                             "a chunk is <= this (e.g. 1e-4; default: run "
                             "the preset's full iteration budget like the "
                             "reference)")
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
                        help="re-run a failed round (--batched, or an "
                             "online round) or live bucket up to N extra "
                             "times, each retry_delay_s (25 s) after the "
                             "failure")
    parser.add_argument("--warmup", action="store_true",
                        help="capture every serving aspect bucket's "
                             "evaluation as a CUDA graph before binding the "
                             "port (with --online: at every batch size "
                             "online rounds dispatch), so that the first "
                             "request captures nothing")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device to serve on (default cuda; raises if "
                             "no card is visible)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: fail first
    from aiohttp import web

    cfg = production_config(PRESETS[args.preset], device=args.device)
    if args.compute_dtype is not None:
        # an explicit dtype changes that field only; the other production
        # settings stand
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    if args.stop_tol is not None:
        cfg = dataclasses.replace(cfg, stop_tol=args.stop_tol)
    if args.stop_shrink is not None:
        cfg = dataclasses.replace(cfg, stop_shrink=args.stop_shrink)
    pairs = (CONTENT_STYLE_FILENAME_PAIRS[:args.max_pairs]
             if args.max_pairs else None)
    if args.batched:
        # the two modes are exclusive: --batched is the offline queue
        # path, so it must not also construct the live executor
        args.online = False
    if args.warmup:
        from ..engine.warmup import warmup_serving

        warmup_serving(cfg, online=args.online, device=args.device)
    app = create_app(config=cfg, data_dir=args.data_dir, pairs=pairs,
                     autostart=not args.no_autostart, batched=args.batched,
                     online=args.online, metrics_path=args.metrics,
                     queue_retries=args.retries, device=args.device)
    web.run_app(app, host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    main()
