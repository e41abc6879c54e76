"""Threaded video capture: camera / video-file frames without blocking the
asyncio loop.

The port's copy of ``fav_tpu/io/video.py``.

Parity target: ``platform/backend/video_source.py`` — a daemon capture thread
so blocking ``cv2.read()`` never stalls the event loop (video_source.py:1-8,
88-89), a mutex-guarded latest-frame slot with a monotonic ``frame_id`` for
duplicate detection (:35,105-117,150-152), resize to 320x240 INTER_AREA
(:29-30,143-148), webcam buffer size 1 (:80-82), file sources looping to the
start on EOF and pacing at native FPS (:134-138,157-159), and webcam read
failure terminating the thread (:139-141).

cv2 is optional at import time (the serving stack must run in image-less
environments); ``start()`` raises if it's unavailable.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

try:
    import cv2  # type: ignore

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False

from fav_tpu_torch.config import VideoParams

__all__ = ["VideoSource"]


class VideoSource:
    """Latest-frame capture wrapper with reference semantics."""

    def __init__(self, params: VideoParams | None = None):
        self.params = params or VideoParams()
        self._cap = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._running = False
        self._frame: Optional[np.ndarray] = None
        self._frame_id = 0
        self._is_file = False
        self._fps = 30.0
        self._taken = False  # latest frame consumed -> decode a fresh one

    @property
    def running(self) -> bool:
        return self._running

    def start(self, source: int | str = 0) -> bool:
        """Open the device/file and start the capture thread. Returns False if
        the source can't be opened (server falls back to simulation mode,
        reference main.py:230-236)."""
        if not _HAS_CV2:
            raise RuntimeError("cv2 is required for live capture")
        self.stop()
        self._is_file = isinstance(source, str)
        cap = cv2.VideoCapture(source)
        if not cap.isOpened():
            cap.release()
            return False
        if not self._is_file:
            cap.set(cv2.CAP_PROP_BUFFERSIZE, 1)  # minimal latency (video_source.py:80-82)
        else:
            fps = cap.get(cv2.CAP_PROP_FPS)
            self._fps = fps if fps and fps > 0 else 30.0
        self._cap = cap
        self._running = True
        with self._lock:
            self._frame = None
            self._frame_id = 0
            self._taken = False
        self._thread = threading.Thread(target=self._capture_loop, daemon=True)
        self._thread.start()
        return True

    def get_frame(self) -> tuple[Optional[np.ndarray], int]:
        """Copy of the latest processed frame and its id (0 = none yet)."""
        with self._lock:
            if self._frame is None:
                return None, 0
            self._taken = True  # demand signal: decode a fresh frame next
            return self._frame.copy(), self._frame_id

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)  # join-with-timeout (video_source.py:92-96)
            self._thread = None
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    # ── capture thread ──
    def _capture_loop(self) -> None:
        p = self.params
        frame_interval = 1.0 / self._fps
        while self._running and self._cap is not None:
            tick_start = time.monotonic()
            if self._is_file and self._frame is not None and not self._taken:
                # demand-driven decode: the consumer hasn't taken the last
                # published frame, so advance the clip in real time with a
                # container-level grab() (~100 us) and skip the JPEG decode
                # + resize (~1-3 ms). With N concurrent streams ticking
                # slower than the clip FPS, decode cost scales with the
                # ANALYZED rate, not N x 30 Hz — on a 1-core serving host
                # 32 idle-decoding streams burned ~2 cores before this
                # (measured, BENCH.md Serving). Playback stays real-time:
                # grabbed-but-undecoded frames are simply dropped, exactly
                # what the latest-frame slot does to decoded frames nobody
                # reads.
                if not self._cap.grab():
                    self._cap.set(cv2.CAP_PROP_POS_FRAMES, 0)  # EOF: loop
                elapsed = time.monotonic() - tick_start
                if elapsed < frame_interval:
                    time.sleep(frame_interval - elapsed)
                continue
            ok, frame = self._cap.read()
            if not ok:
                if self._is_file:
                    # loop file to the start (video_source.py:134-138)
                    self._cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
                    continue
                break  # webcam failure terminates the thread (:139-141)
            if frame.shape[1] != p.process_width or frame.shape[0] != p.process_height:
                frame = cv2.resize(
                    frame, (p.process_width, p.process_height), interpolation=cv2.INTER_AREA
                )
            with self._lock:
                self._frame = frame
                self._frame_id += 1
                self._taken = False
            if self._is_file:
                # pace at native FPS (:157-159)
                elapsed = time.monotonic() - tick_start
                if elapsed < frame_interval:
                    time.sleep(frame_interval - elapsed)
        self._running = False
