"""Container-level audio and video utilities through an ffmpeg binary,
with frame-copy fallbacks.

Counterpart of video_enhancer_tpu/io/audio.py, with the same functions and
status strings. Where an ffmpeg binary exists the source's audio is
demuxed and re-muxed into the enhanced output; where it does not (the
card's machine has none), ``passthrough_audio`` returns
``"dropped (no ffmpeg)"`` and the fallbacks copy frames through io/video.py
(video only; raw ``.avi`` needs no OpenCV). ``resize_video``'s fallback
resizes each frame with the port's INTER_AREA (ops/resize.py
``resize_area``, OpenCV's bit for bit) on the CPU.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["ffmpeg_available", "has_audio_stream", "extract_audio",
           "mux_audio", "passthrough_audio", "clip_video", "concat_videos",
           "resize_video", "convert_format", "add_subtitles"]

_TIMEOUT = 300


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _run(args: list[str]) -> bool:
    try:
        proc = subprocess.run(args, capture_output=True, timeout=_TIMEOUT)
        return proc.returncode == 0
    except Exception:
        return False


def has_audio_stream(video_path) -> bool:
    """True if ffprobe reports at least one audio stream (False when
    ffprobe is unavailable)."""
    ffprobe = shutil.which("ffprobe")
    if ffprobe is None:
        return False
    try:
        proc = subprocess.run(
            [ffprobe, "-v", "error", "-select_streams", "a",
             "-show_entries", "stream=codec_type", "-of", "csv=p=0",
             str(video_path)],
            capture_output=True, timeout=_TIMEOUT)
        return b"audio" in proc.stdout
    except Exception:
        return False


def extract_audio(video_path, audio_path) -> bool:
    """Demux the audio track losslessly (reference video_utils.py:137-166)."""
    if not ffmpeg_available():
        return False
    return _run(["ffmpeg", "-y", "-v", "error", "-i", str(video_path),
                 "-vn", "-acodec", "copy", str(audio_path)])


def mux_audio(video_path, audio_path, out_path) -> bool:
    """Mux an audio file into a video losslessly (video_utils.py:168-199)."""
    if not ffmpeg_available():
        return False
    return _run(["ffmpeg", "-y", "-v", "error", "-i", str(video_path),
                 "-i", str(audio_path), "-c", "copy", "-map", "0:v:0",
                 "-map", "1:a:0", "-shortest", str(out_path)])


def passthrough_audio(source_path, enhanced_path) -> str:
    """Carry the source's audio track into the enhanced output, in place.

    Returns a status string recorded in job stats:
      "copied"              audio successfully re-muxed
      "none"                source has no audio track
      "dropped (no ffmpeg)" no ffmpeg binary at runtime
      "dropped (mux failed)" ffmpeg present but demux/mux failed
    """
    if not ffmpeg_available():
        return "dropped (no ffmpeg)"
    if not has_audio_stream(source_path):
        return "none"
    enhanced = Path(enhanced_path)
    with tempfile.TemporaryDirectory() as td:
        audio = Path(td) / "audio.m4a"
        if not extract_audio(source_path, audio):
            # Stream copy can fail for exotic codecs; retry with AAC encode.
            audio = Path(td) / "audio_enc.m4a"
            if not _run(["ffmpeg", "-y", "-v", "error", "-i",
                         str(source_path), "-vn", "-c:a", "aac",
                         str(audio)]):
                return "dropped (mux failed)"
        muxed = Path(td) / ("muxed" + enhanced.suffix)
        if not mux_audio(enhanced, audio, muxed):
            return "dropped (mux failed)"
        shutil.move(str(muxed), str(enhanced))
    return "copied"


def clip_video(source_path, out_path, start_sec: float,
               duration_sec: float) -> bool:
    """Cut a sub-clip (reference video_utils.py:201-238). ffmpeg stream-copy
    when available; cv2 frame-copy fallback (video only)."""
    if ffmpeg_available():
        return _run(["ffmpeg", "-y", "-v", "error", "-ss", str(start_sec),
                     "-i", str(source_path), "-t", str(duration_sec),
                     "-c", "copy", str(out_path)])
    from .video import get_video_metadata, read_video, write_video

    meta = get_video_metadata(source_path)
    start = int(start_sec * meta.fps)
    count = max(int(duration_sec * meta.fps), 1)
    frames = read_video(source_path, start=start, count=count)
    if frames.shape[0] == 0:
        return False
    write_video(out_path, frames, fps=meta.fps)
    return True


def concat_videos(paths, out_path) -> bool:
    """Concatenate videos (reference video_utils.py:240-281). ffmpeg concat
    demuxer when available; cv2 re-encode fallback (video only, sizes must
    match)."""
    paths = [str(p) for p in paths]
    if not paths:
        return False
    if ffmpeg_available():
        with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                         delete=False) as f:
            for p in paths:
                f.write(f"file '{Path(p).resolve()}'\n")
            listfile = f.name
        ok = _run(["ffmpeg", "-y", "-v", "error", "-f", "concat", "-safe",
                   "0", "-i", listfile, "-c", "copy", str(out_path)])
        Path(listfile).unlink(missing_ok=True)
        return ok
    import numpy as np

    from .video import get_video_metadata, read_video, write_video

    meta = get_video_metadata(paths[0])
    frames = [read_video(p) for p in paths]
    write_video(out_path, np.concatenate(frames, axis=0), fps=meta.fps)
    return True


def resize_video(source_path, out_path, width: int, height: int) -> bool:
    """Rescale a video container-side (reference video_utils.py:168-199).
    ffmpeg scale filter when available (keeps audio); cv2 re-encode
    fallback (video only)."""
    if ffmpeg_available():
        return _run(["ffmpeg", "-y", "-v", "error", "-i", str(source_path),
                     "-vf", f"scale={int(width)}:{int(height)}",
                     "-c:a", "copy", str(out_path)])
    import torch

    from ..ops.resize import resize_area
    from .video import VideoWriter, get_video_metadata, read_video

    meta = get_video_metadata(source_path)
    frames = read_video(source_path)
    if frames.shape[0] == 0:
        return False
    with VideoWriter(out_path, size_hw=(int(height), int(width)),
                     fps=meta.fps) as wr:
        for f in frames:
            wr.write(resize_area(torch.from_numpy(f),
                                 (int(height), int(width))).numpy())
    return True


def convert_format(source_path, out_path) -> bool:
    """Re-container / transcode to the format implied by ``out_path``'s
    extension (reference video_utils.py convert path). ffmpeg stream-copy
    first, transcode on failure; cv2 re-encode fallback (video only)."""
    if ffmpeg_available():
        if _run(["ffmpeg", "-y", "-v", "error", "-i", str(source_path),
                 "-c", "copy", str(out_path)]):
            return True
        return _run(["ffmpeg", "-y", "-v", "error", "-i", str(source_path),
                     str(out_path)])
    from .video import get_video_metadata, read_video, write_video

    meta = get_video_metadata(source_path)
    frames = read_video(source_path)
    if frames.shape[0] == 0:
        return False
    write_video(out_path, frames, fps=meta.fps)
    return True


def add_subtitles(source_path, subtitle_path, out_path,
                  burn_in: bool = False) -> bool:
    """Attach (or burn in) a subtitle file (reference
    video_utils.py:243-262). Requires ffmpeg — there is no cv2 fallback
    for subtitle streams; returns False when unavailable."""
    if not ffmpeg_available():
        return False
    if burn_in:
        # ffmpeg filter-arg quoting: wrap in single quotes with ' and \
        # escaped — a path containing : , ' or [ ] otherwise splits the
        # subtitles= filter expression.
        esc = str(subtitle_path).replace("\\", "\\\\").replace("'", r"\'")
        return _run(["ffmpeg", "-y", "-v", "error", "-i", str(source_path),
                     "-vf", f"subtitles='{esc}'", str(out_path)])
    # Soft-sub codec depends on the output container: mov_text is
    # MP4/MOV-only and makes ffmpeg fail outright for .mkv/.webm.
    ext = str(out_path).rsplit(".", 1)[-1].lower()
    sub_codec = "mov_text" if ext in ("mp4", "m4v", "mov") else "srt"
    return _run(["ffmpeg", "-y", "-v", "error", "-i", str(source_path),
                 "-i", str(subtitle_path), "-c", "copy", "-c:s", sub_codec,
                 str(out_path)])
