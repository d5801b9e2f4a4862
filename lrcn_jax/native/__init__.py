"""Native (C++) runtime components, loaded via ctypes.

The reference's native performance lives in external runtimes (Knet/CUDA for
compute, a Perl process for BLEU scoring — SURVEY.md §2 "Native components").
Here the device compute path is XLA; the host-side runtime pieces are
C++ in this package:

- ``bleu.cpp``        — multi-bleu statistics core (replaces the Perl
  subprocess);
- ``imageloader.cpp`` — threaded JPEG decode/resize/crop feeding the fc7
  extractor (a batched device encoder outruns single-threaded PIL);
- ``httpserve.cpp``   — HTTP front-end for online serving: per-request
  work (accept, parse, queue, respond) in C++, Python entering once per
  coalesced batch (the pure-Python server pays GIL time per request —
  serve/native_http.py).

Libraries build on first use with the system toolchain (g++ -O3 -shared)
into ``_build/`` next to the sources; every consumer has a pure-Python
fallback, so a missing toolchain degrades gracefully.  Set
``LRCN_NATIVE=0`` to disable native paths entirely.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_DIR, "_build")
_LOCK = threading.Lock()
_CACHE: dict[str, ctypes.CDLL | None] = {}
_LINK_FLAGS = {"imageloader": ["-ljpeg", "-pthread"],
               "httpserve": ["-pthread"]}


def native_enabled() -> bool:
    return os.environ.get("LRCN_NATIVE", "1") != "0"


def _build(name: str) -> str | None:
    src = os.path.join(_DIR, f"{name}.cpp")
    lib = os.path.join(_BUILD_DIR, f"lib{name}.so")
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = (["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", lib, src]
           + _LINK_FLAGS.get(name, []))
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    return lib


def load_library(name: str) -> ctypes.CDLL | None:
    """Build (if needed) and dlopen lib<name>.so; None if unavailable."""
    if not native_enabled():
        return None
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        lib_path = _build(name)
        lib = None
        if lib_path is not None:
            try:
                lib = ctypes.CDLL(lib_path)
            except OSError:
                lib = None
        _CACHE[name] = lib
        return lib


def imageloader_library() -> ctypes.CDLL | None:
    """The threaded JPEG loader with argtypes configured, or None."""
    lib = load_library("imageloader")
    if lib is None:
        return None
    if not getattr(lib, "_lrcn_configured", False):
        lib.lrcn_load_images.restype = ctypes.c_int
        lib.lrcn_load_images.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.lrcn_load_images_mem.restype = ctypes.c_int
        lib.lrcn_load_images_mem.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(
                ctypes.c_longlong), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib._lrcn_configured = True
    return lib


def bleu_library() -> ctypes.CDLL | None:
    """The BLEU core with argtypes configured, or None."""
    lib = load_library("bleu")
    if lib is None:
        return None
    if not getattr(lib, "_lrcn_configured", False):
        lib.lrcn_bleu_stats_new.restype = ctypes.c_void_p
        lib.lrcn_bleu_stats_free.argtypes = [ctypes.c_void_p]
        lib.lrcn_bleu_accumulate.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int]
        lib.lrcn_bleu_get.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_longlong)]
        lib._lrcn_configured = True
    return lib


def loadgen_binary() -> str | None:
    """Build (if needed) the standalone C++ load generator; path or None.

    Unlike the libraries above this is an executable, run via
    subprocess: load generation must live outside this process (and
    outside Python entirely) for the serving capacity numbers to
    measure the server rather than the client (loadgen.cpp header).
    """
    if not native_enabled():
        return None
    src = os.path.join(_DIR, "loadgen.cpp")
    exe = os.path.join(_BUILD_DIR, "lrcn_loadgen")
    with _LOCK:
        if os.path.exists(exe) \
                and os.path.getmtime(exe) >= os.path.getmtime(src):
            return exe
        os.makedirs(_BUILD_DIR, exist_ok=True)
        cmd = ["g++", "-O2", "-std=c++17", "-pthread", "-o", exe, src]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError):
            return None
        return exe


def httpserve_library() -> ctypes.CDLL | None:
    """The native HTTP front-end with argtypes configured, or None."""
    lib = load_library("httpserve")
    if lib is None:
        return None
    if not getattr(lib, "_lrcn_configured", False):
        LL = ctypes.c_longlong
        lib.lrcn_serve_start.restype = ctypes.c_void_p
        lib.lrcn_serve_start.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int]
        lib.lrcn_serve_port.restype = ctypes.c_int
        lib.lrcn_serve_port.argtypes = [ctypes.c_void_p]
        lib.lrcn_serve_next.restype = ctypes.c_int
        lib.lrcn_serve_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(LL), ctypes.POINTER(LL),
            ctypes.POINTER(LL), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.lrcn_serve_set_feature_dim.argtypes = [
            ctypes.c_void_p, ctypes.c_int]
        lib.lrcn_serve_set_image_support.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.lrcn_serve_next_image.restype = LL
        lib.lrcn_serve_next_image.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(LL), ctypes.POINTER(LL),
            ctypes.POINTER(ctypes.c_char), LL, ctypes.c_int]
        lib.lrcn_serve_respond.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(LL), ctypes.POINTER(LL),
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
        lib.lrcn_serve_set_vocab.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int]
        lib.lrcn_serve_set_id_rows.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(LL), ctypes.POINTER(LL), LL]
        lib.lrcn_serve_ready.argtypes = [ctypes.c_void_p]
        lib.lrcn_serve_respond_tokens.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(LL), ctypes.POINTER(LL),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.lrcn_serve_error.argtypes = [ctypes.c_void_p, LL,
                                         ctypes.c_int, ctypes.c_char_p]
        lib.lrcn_serve_stop.argtypes = [ctypes.c_void_p]
        lib._lrcn_configured = True
    return lib
