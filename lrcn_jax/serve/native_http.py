"""Native (C++) HTTP front-end: per-request work out of the GIL.

Every request on the pure-Python server costs Python time — HTTP
parse, future, queue hop, thread wakeup — under the GIL, which caps it
under many concurrent clients.  ``native/httpserve.cpp`` moves ALL
per-request work into C++; this module runs the per-BATCH half: a pump
thread pulls coalesced (id, request, slot) items, maps ids to feature
rows, issues the batched on-device beam search, and pushes caption
strings back.  Dispatch N+1 issues while batch N's tokens transfer
back (same pipelining as serve/batcher.py).

Scope: the full endpoint contract.  Caption-by-id (int32 row indices
against the HBM-resident table) and raw fc7 features (parsed to float
rows in C++, decoded via the grouped scanned feature dispatch) run
through the main pump; base64 images (decoded to bytes in C++) run
through a dedicated image thread feeding the service's VGG encode
stage — enabled when the service has an encoder, 501 otherwise.
/healthz and /stats answer entirely in C++.
"""

from __future__ import annotations

import ctypes
import threading
import time

import numpy as np

from lrcn_jax.native import httpserve_library
from lrcn_jax.serve.service import CaptionService

_LL = ctypes.c_longlong


class NativeFrontend:
    """Bind the C++ HTTP server to a ``CaptionService``'s decode path.

    Caption-by-id needs the service's HBM-resident feature table (the
    id fast path: the device feed is int32-only end to end); without a
    table (a features-only, external-encoder deployment) id requests
    get a 400 and feature requests still serve.
    """

    def __init__(self, service: CaptionService, host: str = "0.0.0.0",
                 port: int = 8000, n_threads: int = 128,
                 max_queue: int = 4096, wait_ms: int = 3,
                 max_inflight: int = 2, fill_ms: int = 20,
                 feat_wait_ms: float = 200.0):
        lib = httpserve_library()
        if lib is None:
            raise RuntimeError("native httpserve library unavailable "
                               "(g++ missing or LRCN_NATIVE=0)")
        self.service = service
        self._lib = lib
        # the C++ side only binds numeric addresses (a bad string would
        # otherwise silently become 0.0.0.0) — resolve names here
        import socket as _socket

        host_ip = _socket.gethostbyname(host)
        self._h = lib.lrcn_serve_start(
            host_ip.encode(), port, n_threads, max_queue,
            int(service.request_timeout_s * 1000))
        if not self._h:
            raise RuntimeError(f"could not bind {host_ip}:{port}")
        self.port = lib.lrcn_serve_port(self._h)
        self._wait_ms = wait_ms
        self._fill_ms = fill_ms
        self._max_inflight = max_inflight
        self._feat_wait_s = feat_wait_ms / 1e3
        # register the vocab so responses are built in C++ from raw
        # device tokens (no Python per-caption detokenize + encode loop)
        words = [service.vocab.word(i).encode()
                 for i in range(len(service.vocab))]
        lib.lrcn_serve_set_vocab(
            self._h, (ctypes.c_char_p * len(words))(*words), len(words))
        # enable {"features": [[...], ...]} bodies: C++ parses rows of
        # exactly this many floats and ships them through the queue
        self._feat_dim = int(service.cfg.cnn_feature_dim)
        lib.lrcn_serve_set_feature_dim(self._h, self._feat_dim)
        # register the id -> store-row map: connection threads resolve
        # ids (and 400 unknown ones) at parse time in C++, so the pump
        # receives ready row indices — per-item Python row resolution
        # was the largest pump cost at the r4 capacity knee.  The store
        # is frozen for the life of the service (its table is already
        # resident in HBM), so a one-time snapshot is safe.
        self._rows_resolved = False
        if service.store is not None and service._table is not None:
            sids = np.asarray(service.store.ids(), np.int64)
            srows = np.asarray(service.store.rows(sids), np.int64)
            lib.lrcn_serve_set_id_rows(
                self._h,
                sids.ctypes.data_as(ctypes.POINTER(_LL)),
                srows.ctypes.data_as(ctypes.POINTER(_LL)),
                len(sids))
            self._rows_resolved = True
        # pre-compile every burst shape so traffic never recompiles
        # (grouped drain works under a mesh too: groups scan, each
        # batch shards along 'data'); no-op if warmup() already ran
        service.warmup_burst_shapes()
        service.warmup_feature_burst_shapes()
        self._stop = threading.Event()
        # issued-but-unresponded batches flow pump -> responder through
        # this queue; the budget bounds how many can be in flight (the
        # pump blocks acquiring it — i.e. on the responder's progress)
        import queue as _queue

        self._respq: _queue.Queue = _queue.Queue()
        self._resp_budget = threading.Semaphore(max_inflight)
        # feature dispatches hold their OWN slot: a feature batch in
        # flight must not eat the id pipeline's depth or stall the
        # pull gate (shared budgets under mixed traffic would add whole
        # feature-finalize waits to the id path's tail)
        self._feat_budget = threading.Semaphore(1)
        self._inflight = 0
        # += / -= across two threads is a non-atomic read-modify-write:
        # a lost decrement would wedge _inflight above 0 forever and
        # permanently disable the feature accumulator's idle fast path
        self._inflight_mu = threading.Lock()
        self._last_responded = 0
        self.pending_hwm = 0
        self._img_thread = None
        if service._encode is not None:
            # base64-image bodies: C++ decodes to bytes; this thread
            # feeds them through the service's encode (VGG) stage.
            # max_blobq bounds decoded-bytes memory (images are MBs)
            lib.lrcn_serve_set_image_support(self._h, 1, 64)
            self._img_thread = threading.Thread(
                target=self._run_images, name="lrcn-img", daemon=True)
        self._responder = threading.Thread(
            target=self._run_responder, name="lrcn-respond", daemon=True)
        self._pump = threading.Thread(target=self._run, name="lrcn-pump",
                                      daemon=True)
        self._responder.start()
        self._pump.start()
        if self._img_thread is not None:
            self._img_thread.start()
        # open /v1/caption LAST: the C++ listener is live from
        # lrcn_serve_start (port bound, /healthz answering), but a
        # caption request accepted before set_id_rows would enqueue a
        # raw image id the pump would treat as a STORE ROW — the
        # wrong caption with a 200, not an error.  Until this call the
        # endpoint answers 503 "warming up".
        lib.lrcn_serve_ready(self._h)

    # --- pump thread: per-batch Python ---

    def _pull(self, max_n: int, expect: int = 0):
        ids = (_LL * max_n)()
        reqs = (_LL * max_n)()
        slots = (_LL * max_n)()
        feats = np.empty((max_n, self._feat_dim), np.float32)
        isfeat = (ctypes.c_ubyte * max_n)()
        n = self._lib.lrcn_serve_next(
            self._h, ids, reqs, slots,
            feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            isfeat, max_n, self._wait_ms, self._fill_ms, expect)
        return n, ids, reqs, slots, feats, isfeat

    def _run(self) -> None:
        svc = self.service
        store = svc.store
        # burst absorption: pull up to G batches per cycle and drain
        # them in ONE scanned dispatch (service._rows_search_scan) —
        # per-batch dispatching costs ~1/3 more at full backlog
        batch_cap = svc.decode_batch * svc.MAX_DECODE_GROUPS
        self.pending_hwm = 0   # in-flight high water (mixed-traffic
        #                        regression instrument: must stay within
        #                        the in-flight budget)
        # feature accumulator: a grouped feature dispatch costs the same
        # device time for 8 rows as for 1024 (the 20-step beam scan is
        # nearly batch-size-flat), so dispatching a sliver of feature
        # rows EVERY cycle under mixed traffic doubles every cycle's
        # device cost for a few percent of the items.  Feature rows age up to feat_wait_ms
        # (or up to batch_cap rows) before dispatching; when the pump is
        # otherwise idle they flush immediately, so feature-only
        # deployments and low-load latency are unchanged.
        feat_rows: list = []
        feat_reqs: list = []
        feat_slots: list = []
        feat_n = 0
        feat_first = 0.0     # monotonic arrival of the oldest row held

        def issue(fn, reqs_arr, slots_arr, budget):
            # blocks on the in-flight budget — i.e. on the RESPONDER's
            # progress, overlapping its finalize work — then issues the
            # device dispatch and hands the raw handle off.  On an issue
            # failure the budget is returned and the caller's except
            # path errors the requests.  On shutdown the acquire wait is
            # abandoned; the item ships with budget=None so the
            # responder never releases a slot that was never acquired.
            acquired = False
            while not acquired:
                acquired = budget.acquire(timeout=0.5)
                if not acquired and self._stop.is_set():
                    break   # shutting down: the responder drains it
            try:
                raw = fn()
            except BaseException:
                if acquired:
                    budget.release()
                raise
            with self._inflight_mu:
                self._inflight += 1
                if self._inflight > self.pending_hwm:
                    self.pending_hwm = self._inflight
            self._respq.put((raw, reqs_arr, slots_arr,
                             budget if acquired else None))

        def flush_feats():
            nonlocal feat_rows, feat_reqs, feat_slots, feat_n
            rows = (feat_rows[0] if len(feat_rows) == 1
                    else np.concatenate(feat_rows))
            reqs_arr = (feat_reqs[0] if len(feat_reqs) == 1
                        else np.concatenate(feat_reqs))
            slots_arr = (feat_slots[0] if len(feat_slots) == 1
                         else np.concatenate(feat_slots))
            issue(lambda: svc._decode_feats_grouped(rows),
                  reqs_arr, slots_arr, self._feat_budget)
            # clear ONLY after a successful hand-off: if issue() raises,
            # the accumulator still holds these requests and the pump's
            # except path fast-fails them (clearing first would strand
            # aged rows from earlier pulls until the C++ 504 timeout)
            feat_rows, feat_reqs, feat_slots, feat_n = [], [], [], 0

        while not self._stop.is_set():
            n = 0
            # this pull's items while they are still OURS: the id batch
            # until issue() hands it to the responder, the feature items
            # until they land in the accumulator.  The except path fails
            # exactly these plus the accumulator — never batches already
            # handed off (the responder finalizes or errors those
            # independently) and never the features-only 400s already
            # answered.
            cycle_id_reqs = None
            cycle_feat_reqs = None
            try:
                # throttle: wait for a free in-flight slot BEFORE
                # pulling — while the device works, arrivals coalesce
                # in the C++ queue and the next pull drains them as ONE
                # grouped dispatch.  Without this gate the pump pulls
                # slivers and issues many small dispatches (each costs
                # the same batch-size-flat device time), losing
                # throughput and raising the open-loop p99.  The slot frees exactly when the
                # responder finishes a respond, which also refreshes
                # the arrival forecast the pull uses — the same
                # respond->refill->pull cadence the inline-finalize
                # pump had.  (acquire+release is race-free: this thread
                # is the only acquirer.)
                while not self._resp_budget.acquire(timeout=0.5):
                    if self._stop.is_set():
                        break
                else:
                    self._resp_budget.release()
                n, ids, reqs, slots, feats, isfeat = self._pull(
                    batch_cap, expect=self._take_forecast())
                if n:
                    # zero-copy views over the pulled ctypes buffers
                    # (fresh buffers every pull; the views pin them)
                    flags = np.frombuffer(isfeat, np.uint8, n)
                    ids_np = np.frombuffer(ids, np.int64, n)
                    reqs_np = np.frombuffer(reqs, np.int64, n)
                    slots_np = np.frombuffer(slots, np.int64, n)
                    id_idx = np.flatnonzero(flags == 0)
                    feat_idx = np.flatnonzero(flags)
                    if id_idx.size and not self._rows_resolved:
                        # features-only deployment: ids have no resident
                        # table to resolve against (C++ map unregistered)
                        for i in id_idx:
                            self._lib.lrcn_serve_error(
                                self._h, int(reqs_np[i]), 400,
                                b"caption-by-id needs a feature store "
                                b"(features-only deployment)")
                        id_idx = id_idx[:0]
                    if feat_idx.size:
                        cycle_feat_reqs = np.ascontiguousarray(
                            reqs_np[feat_idx])
                    if id_idx.size:
                        # ids are already STORE ROWS (resolved at parse
                        # time in C++; unknown ids 400'd there) — issue
                        # the grouped dispatch with no per-item Python
                        rows = (ids_np if id_idx.size == n
                                else ids_np[id_idx])
                        cycle_id_reqs = np.ascontiguousarray(
                            reqs_np[id_idx])
                        id_slots = np.ascontiguousarray(
                            slots_np[id_idx])
                        issue(lambda: svc._decode_rows_grouped(rows),
                              cycle_id_reqs, id_slots,
                              self._resp_budget)
                        cycle_id_reqs = None   # handed off
                    if feat_idx.size:
                        # raw fc7 rows: ACCUMULATE (see flush_feats) —
                        # they dispatch grouped, after aging or when the
                        # pump is idle, so a trickle of feature rows
                        # cannot double every cycle's device cost
                        if feat_n + feat_idx.size > batch_cap:
                            flush_feats()     # never exceed the grouped
                            #                   program's 4x256 capacity
                        if not feat_n:
                            feat_first = time.monotonic()
                        feat_rows.append(feats[feat_idx])
                        feat_reqs.append(cycle_feat_reqs)
                        feat_slots.append(
                            np.ascontiguousarray(slots_np[feat_idx]))
                        feat_n += feat_idx.size
                        cycle_feat_reqs = None   # in the accumulator
                if feat_n and (
                        feat_n >= batch_cap
                        or time.monotonic() - feat_first
                        >= self._feat_wait_s
                        # idle fast path: nothing else to overlap with —
                        # feature-only deployments and low-load requests
                        # keep their unaged latency
                        or self._inflight == 0):
                    flush_feats()
            except Exception as e:   # noqa: BLE001 — the pump must
                # outlive ANY issue failure: fail the requests still in
                # OUR hands (the C++ side 504s anything we lose track
                # of) and keep serving.  Batches already handed to the
                # responder are its to finalize or error; 400s already
                # answered stay answered.
                print(f"native pump: batch failed: {e!r}", flush=True)
                for preqs in feat_reqs:   # accumulated, not yet issued
                    for r in preqs:
                        self._lib.lrcn_serve_error(
                            self._h, int(r), 500, b"decode failed")
                feat_rows, feat_reqs, feat_slots, feat_n = [], [], [], 0
                if cycle_id_reqs is not None:   # id issue itself failed
                    for r in cycle_id_reqs:
                        self._lib.lrcn_serve_error(
                            self._h, int(r), 500, b"decode failed")
                if cycle_feat_reqs is not None:  # pull's feats unbanked
                    for r in cycle_feat_reqs:
                        self._lib.lrcn_serve_error(
                            self._h, int(r), 500, b"decode failed")
        # hand any aged feature rows to the responder, then stop it:
        # the sentinel queues BEHIND every in-flight batch, so the
        # responder drains them all before exiting
        if feat_n:
            try:
                flush_feats()
            except Exception:   # noqa: BLE001 — 504 fallback in C++
                pass
        self._respq.put(None)

    def _take_forecast(self) -> int:
        # items in the last responded batch: the pull's arrival forecast
        # (closed-loop clients re-request as soon as they hear back).
        # Read-and-zero so a stale value can't force full fill-window
        # waits once load drops; plain int ops are GIL-atomic and the
        # forecast is a heuristic either way.
        r = self._last_responded
        self._last_responded = 0
        return r

    def _run_responder(self) -> None:
        """Finalize + respond OFF the pump thread.

        ``_respond_raw`` blocks on the device for each batch's tokens
        (releasing the GIL); doing that inline in the pump serialized
        every cycle behind a device wait, capping issue rate — under
        mixed traffic each cycle waited out BOTH the id and the feature
        finalize.  Here the pump only pulls and issues; this thread
        absorbs the device waits, bounded by ``max_inflight`` via the
        budget semaphore the pump acquires per issue."""
        while True:
            item = self._respq.get()
            if item is None:
                return
            raw, preqs, pslots, budget = item
            try:
                self._respond_raw(preqs, pslots, raw)
                self._last_responded = len(preqs)
            except Exception as e:   # noqa: BLE001 — a failed batch
                # must not kill the responder: error ITS requests fast
                # (without this they'd sit out the request timeout)
                print(f"native responder: batch failed: {e!r}",
                      flush=True)
                for r in np.asarray(preqs).tolist():
                    self._lib.lrcn_serve_error(
                        self._h, int(r), 500, b"decode failed")
            finally:
                with self._inflight_mu:
                    self._inflight -= 1
                if budget is not None:   # None = issued during shutdown
                    budget.release()

    def _run_images(self) -> None:
        """Image thread: pull decoded blobs, batch them through the
        service's encode stage, respond.

        The JPEG decode runs in the threaded C++ loader
        (``native/imageloader.cpp`` in-memory mode, PIL rescue for
        PNG/odd formats) — one batched call per pull, releasing the GIL
        for the whole decode so sustained image traffic cannot starve
        the id/feature pump.  The C++ front-end owns
        accept/parse/base64/respond.  Batching: after the first blob
        arrives, drain whatever else is queued (up to the encode batch)
        so concurrent image requests coalesce into one VGG dispatch.

        PIPELINED: the encode+beam round trip (device dispatches + link
        RTT) runs in a bounded pool of dispatch threads, so this thread
        decodes batch N+1's JPEGs while batch N is on the device, so
        the serial decode→dispatch→respond cycle is not the ceiling.
        Depth 2 is enough: one batch decoding, one in flight."""
        import threading as _threading

        from lrcn_jax.data.images import load_blobs

        svc = self.service
        buf_cap = 16 << 20
        buf = ctypes.create_string_buffer(buf_cap)
        req = _LL()
        slot = _LL()

        def pull_one(wait_ms: int):
            nonlocal buf, buf_cap
            n = self._lib.lrcn_serve_next_image(
                self._h, ctypes.byref(req), ctypes.byref(slot), buf,
                buf_cap, wait_ms)
            if n < 0:                      # blob bigger than the buffer
                buf_cap = int(-n)
                buf = ctypes.create_string_buffer(buf_cap)
                n = self._lib.lrcn_serve_next_image(
                    self._h, ctypes.byref(req), ctypes.byref(slot), buf,
                    buf_cap, wait_ms)
            if n <= 0:
                return None
            return int(req.value), int(slot.value), buf.raw[:n]

        depth = 2
        sem = _threading.Semaphore(depth)
        from concurrent.futures import ThreadPoolExecutor

        # PERSISTENT workers, not a thread per batch: at the image knee
        # (dozens of batches/s) per-batch thread creation is avoidable
        # scheduler churn on the 1-core hosts these benches target
        pool = ThreadPoolExecutor(max_workers=depth,
                                  thread_name_prefix="lrcn-img-dispatch")

        def dispatch(images, metas):
            try:
                caps = svc.caption_images(images)
                self._respond([r for r, _ in metas],
                              [s for _, s in metas], caps)
            except Exception as e:   # noqa: BLE001 — outlive failures
                print(f"native image thread: batch failed: {e!r}",
                      flush=True)
                for r, _ in metas:
                    self._lib.lrcn_serve_error(
                        self._h, r, 500, b"encode failed")
            finally:
                sem.release()

        max_batch = svc._encode.max_batch
        while not self._stop.is_set():
            first = pull_one(50)
            if first is None:
                continue
            batch = [first]
            while len(batch) < max_batch:
                nxt = pull_one(0)
                if nxt is None:
                    break
                batch.append(nxt)
            decoded, ok = load_blobs([blob for _, _, blob in batch])
            images, metas = [], []
            for (r, s, _), img, good in zip(batch, decoded, ok):
                if good:
                    images.append(img)
                    metas.append((r, s))
                else:                 # bad bytes = client error
                    self._lib.lrcn_serve_error(
                        self._h, r, 400, b"could not decode image")
            if not images:
                continue
            # bound the pipeline: at most `depth` batches past decode
            # (their requests are protected by the C++ request timeout
            # either way); stay responsive to stop() while full
            while not sem.acquire(timeout=0.5):
                if self._stop.is_set():
                    break
            else:
                pool.submit(dispatch, images, metas)
        # in-flight dispatches finish (bounded by caption_images +
        # respond); their requests would 504 via C++ otherwise
        pool.shutdown(wait=True)

    def _respond(self, preqs, pslots, captions) -> None:
        k = len(captions)
        self._lib.lrcn_serve_respond(
            self._h, (_LL * k)(*[int(r) for r in preqs]),
            (_LL * k)(*[int(s) for s in pslots]),
            (ctypes.c_char_p * k)(*[c.encode() for c in captions]), k)

    def _respond_raw(self, preqs, pslots, raw) -> None:
        """Finalize + respond WITHOUT per-item Python: fetch the token
        array (the async host copy started at issue time), pass the
        req/slot arrays as raw pointers, and let C++ detokenize against
        the registered vocab."""
        from lrcn_jax.core.vocab import EOS_ID

        n, tokens = raw
        toks = np.ascontiguousarray(np.asarray(tokens), dtype=np.int32)
        toks = toks.reshape(-1, toks.shape[-1])   # (G*B | B, T)
        preqs = np.ascontiguousarray(np.asarray(preqs, np.int64))
        pslots = np.ascontiguousarray(np.asarray(pslots, np.int64))
        self._lib.lrcn_serve_respond_tokens(
            self._h, preqs.ctypes.data_as(ctypes.POINTER(_LL)),
            pslots.ctypes.data_as(ctypes.POINTER(_LL)),
            toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            toks.shape[1], EOS_ID, len(preqs))

    # --- ops ---

    def stop(self) -> None:
        self._stop.set()
        self._pump.join(timeout=10)          # enqueues the sentinel...
        self._responder.join(timeout=10)     # ...which drains in order
        if self._img_thread is not None:
            self._img_thread.join(timeout=10)
        self._lib.lrcn_serve_stop(self._h)
