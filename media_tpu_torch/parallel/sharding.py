"""Multi-device frame encoding: MB-row tiles, one slice per device, with
halo rows copied between neighbouring tiles.

The port of media_tpu/parallel/sharding.py. A frame's MB rows are split
into n equal tiles over an ordered tuple of torch devices (the port's
"mesh"; make_tile_mesh). A tile is one slice of the picture, coded end to
end on its device: motion estimation, transform and quantisation, the
device CAVLC packer and slice-local deblocking (disable_deblocking_filter_idc
2, so kernel 1 runs on the tile alone). Only two things cross tiles, as in
the original: the reference rows motion estimation reads beyond a tile's
edge (`search_range + INTERP_HALO` luma rows and `search_range // 2 + 2`
chroma rows from each neighbour, copied to the tile's device where the
original used `ppermute` over ICI), and under CBR each frame's bit count,
summed over the tiles as an integer before the float32 rate update (the
original's `psum`). The access units equal those of the single-device
session with `num_slices = n`, `deblock_across_slices=False` and
`entropy_mode="host"`.

The original runs a P run as one `shard_map` program; this module runs it
as a loop over frames and, inside a frame, over the tiles, from one host
thread. The devices may repeat: `["cuda:0"] * 4` runs four tiles on one
card, `["cpu"] * n` runs them in the CPU tests. Tiles of one geometry on
one CUDA stream share kernel 1's mailbox (ops/deblock_wave.py:_mailbox);
their launches are ordered on that stream, and each launch leaves the
mailbox zero for the next.

`DevicePool` and `get_pool` place sessions over the devices by load (the
API's placement, api/encoder_api.py:_place_session).

Deliberate differences from the original: ShardedEncoderSession refuses
`cabac=True` and `lossless=True` (ValueError), since the original writes
the device packer's CAVLC slice data under the base session's CABAC PPS
(a stream its own TpuDecoder refuses) and codes a lossless configuration
as a lossy IDR + P stream (its P run never writes I_PCM); and it has the
`encode_frame` the API calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.nal import H264NalType, wrap_nal
from ..device import resolve_device
from ..entropy.device_cavlc import (
    _last_coded, merge_slice_data, pack_pslice_device)
from ..ops.transform import chroma_qp
from ..pipeline.codec import EncoderSession
from ..pipeline.deblock_apply import deblock_pframe_from_symbols
from ..pipeline.encoder import FrameEncoder, IFrameResult
from ..pipeline.pframe_core import (
    INTERP_HALO, chroma_qp_device, local_pframe_core, unpack_symbols,
    unpack_symbols_device)
from ..utils import yuv


def make_tile_mesh(n_devices: int | None = None, devices=None) -> tuple:
    """The tile "mesh": an ordered tuple of torch devices. Without a list,
    the first `n_devices` CUDA devices (all of them for None); without CUDA
    and without a list it raises. A list may repeat a device."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())][:n_devices]
    mesh = tuple(resolve_device(d) for d in devices)
    if not mesh:
        raise ValueError("no devices for the tile mesh")
    return mesh


class DevicePool:
    """Load-aware session placement over the local devices — the analog of
    the reference's shared-memory device pool with least-load auto-allocation
    (ni_rsrc_allocate_auto, EN_ALLOC_LEAST_LOAD, vendor/netint/
    ni_rsrc_api.h:57-61,343-348) and its pixel-rate load model
    (`xcode_load_pixel`, ni_rsrc_api.h:106).

    Load unit: pixels/second of admitted work (width*height*fps per
    session). allocate() returns the n least-loaded devices for a new
    session; release() returns the capacity.

    devices: the caller's list (e.g. ["cpu"] * n), else every CUDA device;
    without CUDA and without a list it raises, as every entry point of the
    port does.
    """

    def __init__(self, devices=None):
        if devices is None:
            resolve_device("cuda")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self._devices = list(devices)
        self._load = {i: 0 for i in range(len(self._devices))}
        self._sessions: dict[int, tuple] = {}
        self._next_id = 0

    def loads(self) -> list[int]:
        return [self._load[i] for i in range(len(self._devices))]

    def allocate(self, width: int, height: int, fps: int = 30,
                 n_devices: int = 1):
        """Least-load placement: returns (session_id, [devices])."""
        if n_devices > len(self._devices):
            raise ValueError("not enough devices in the pool")
        per_dev = (width * height * fps) // n_devices
        order = sorted(range(len(self._devices)), key=lambda i: self._load[i])
        chosen = sorted(order[:n_devices])  # mesh order stays stable
        for i in chosen:
            self._load[i] += per_dev
        sid = self._next_id
        self._next_id += 1
        self._sessions[sid] = (tuple(chosen), per_dev)
        return sid, [self._devices[i] for i in chosen]

    def release(self, session_id: int) -> None:
        chosen, per_dev = self._sessions.pop(session_id)
        for i in chosen:
            self._load[i] -= per_dev


_POOL = None


def get_pool() -> "DevicePool":
    """Process-global pool over the CUDA devices — the analog of the
    reference's host-wide shared-memory resource pool
    (vendor/netint/ni_rsrc_api.h:92-96; one pool per host, sessions from
    any factory call draw from it)."""
    global _POOL
    if _POOL is None:
        _POOL = DevicePool()
    return _POOL


def _tile_rows(mesh, height: int, search_range: int | None = None) -> int:
    """MB rows of one tile; raises where the rows do not divide evenly or
    a tile is shorter than the halo that motion estimation reads."""
    n_dev = len(mesh)
    n_rows = height // 16
    if n_rows % n_dev:
        raise ValueError(f"MB rows {n_rows} not divisible by {n_dev} devices")
    rows_local = n_rows // n_dev
    if (search_range is not None
            and rows_local * 16 < search_range + INTERP_HALO):
        raise ValueError("tile shorter than the ME + interpolation halo")
    return rows_local


def split_tiles(plane, mesh, axis: int = 0) -> list:
    """A plane (H, W) or a stack (K, H, W), numpy or a tensor, cut along
    `axis` into len(mesh) equal row tiles, each on its device."""
    x = plane if torch.is_tensor(plane) else torch.tensor(np.asarray(plane))
    return [t.to(dev) for t, dev in zip(x.chunk(len(mesh), dim=axis), mesh)]


def gather_tiles(tiles, device) -> torch.Tensor:
    """The row tiles of a plane, concatenated on `device`."""
    return torch.cat([t.to(device) for t in tiles])


def _halo_exchange_rows(tiles, halo: int) -> list:
    """Each tile of `tiles` (a plane's row tiles, in order) extended by
    `halo` rows above and below: the neighbours' boundary rows, copied to
    the tile's device. Edge tiles replicate their own border row (no ring
    wrap), as the single-device edge padding does."""
    n = len(tiles)
    out = []
    for i, local in enumerate(tiles):
        dev = local.device
        top = (tiles[i - 1][-halo:].to(dev) if i > 0
               else local[:1].expand(halo, -1))
        bot = (tiles[i + 1][:halo].to(dev) if i < n - 1
               else local[-1:].expand(halo, -1))
        out.append(torch.cat([top, local, bot]))
    return out


def _pframe_cores(cur, ref, qps, search_range: int, rows_local: int,
                  n_cols: int) -> list:
    """local_pframe_core on every tile. cur, ref: (y, u, v) triples of row
    tiles; qps: per tile its (qp, qp_c), Python ints or tensors on the
    tile's device. The reference tiles get their halo rows first."""
    halo_y = search_range + INTERP_HALO
    halo_c = search_range // 2 + 2
    ext = [_halo_exchange_rows(tiles, h)
           for tiles, h in zip(ref, (halo_y, halo_c, halo_c))]
    i32 = torch.int32
    return [local_pframe_core(*(p[t].to(i32) for p in cur),
                              *(e[t].to(i32) for e in ext), *qps[t],
                              search_range, rows_local, n_cols)
            for t in range(len(qps))]


def _recon(out) -> tuple:
    return out["recon_y"], out["recon_u"], out["recon_v"]


def make_sharded_pframe_step(mesh, height: int, width: int,
                             search_range: int = 8):
    """The multi-device P-frame step, without entropy coding or
    deblocking: a function (y, u, v, ref_y, ref_u, ref_v, qp, qp_c) of
    whole planes (numpy or tensors) -> {"symbols": the tiles' symbol
    tensors gathered on the host, "recon_y/u/v": each a list of row tiles
    left on their devices for the next frame, "sad_total": the tiles' SAD
    summed as an int32 on mesh[0]}."""
    rows_local = _tile_rows(mesh, height, search_range)
    n_cols = width // 16

    def step(y, u, v, ref_y, ref_u, ref_v, qp: int, qp_c: int):
        cur = [split_tiles(p, mesh) for p in (y, u, v)]
        ref = [split_tiles(p, mesh) for p in (ref_y, ref_u, ref_v)]
        outs = _pframe_cores(cur, ref, [(int(qp), int(qp_c))] * len(mesh),
                             search_range, rows_local, n_cols)
        recon = list(zip(*(_recon(o) for o in outs)))
        return {
            "symbols": torch.cat([o["symbols"].cpu() for o in outs]),
            "recon_y": list(recon[0]),
            "recon_u": list(recon[1]),
            "recon_v": list(recon[2]),
            "sad_total": torch.stack([o["sad_total"].to(mesh[0])
                                      for o in outs]).sum(dtype=torch.int32),
        }

    return step


def _download(per_frame) -> torch.Tensor:
    """Per frame, per tile device tensors -> one (K, n, ...) host tensor."""
    return torch.stack([torch.stack([x.cpu() for x in row])
                        for row in per_frame])


def make_sharded_encode_fn(mesh, height: int, width: int,
                           search_range: int = 8, deblock: bool = True):
    """Full multi-device P-run encoder: each device owns one MB-row tile ==
    one slice, end to end — halo'd ME/MC + transform/quant + slice-local
    deblocking (disable_deblocking_filter_idc == 2 semantics) + the on-tile
    device CAVLC packer. Only the reference-frame halo crosses tiles;
    entropy and deblock are tile-local by construction, so the output
    slices are byte-identical to a single-device multi-slice encode.

    Returns (fn, rows_local, cap_local): fn(ys, us, vs, ry, ru, rv, qp,
    qp_c), each argument a list of row tiles on their devices (ys[t] of
    shape (K, rows_local*16, W)); outputs (streams (K, n, cap_local) int64
    words, bits (K, n), both on the host; the recon as a (y, u, v) triple
    of row tile lists on the devices)."""
    n_dev = len(mesh)
    rows_local = _tile_rows(mesh, height, search_range)
    n_cols = width // 16
    cap_local = max(rows_local * 16 * width // 16, 16384 // n_dev)

    def fn(ys, us, vs, ry, ru, rv, qp: int, qp_c: int):
        recon = (list(ry), list(ru), list(rv))
        streams, bits = [], []
        for j in range(ys[0].shape[0]):
            outs = _pframe_cores(
                [[p[j] for p in planes] for planes in (ys, us, vs)], recon,
                [(qp, qp_c)] * n_dev, search_range, rows_local, n_cols)
            recon = ([], [], [])
            streams.append([])
            bits.append([])
            for out in outs:
                stream, nbits = pack_pslice_device(
                    *unpack_symbols_device(out["symbols"]), cap_local)
                r2 = _recon(out)
                if deblock:
                    r2 = deblock_pframe_from_symbols(
                        *r2, out["symbols"], qp, qp_c, rows_local, n_cols)
                for plane, tile in zip(recon, r2):
                    plane.append(tile)
                streams[-1].append(stream)
                bits[-1].append(nbits)
        return _download(streams), _download(bits), recon

    return fn, rows_local, cap_local


def make_sharded_iframe_fn(mesh, height: int, width: int, deblock: bool,
                           i4x4: bool):
    """Tile-parallel intra frame: each device runs the intra wavefront on
    its own MB-row tile. With one slice per tile, intra prediction never
    crosses tile boundaries (top row unavailable at a slice start) and
    deblocking is slice-local (idc == 2), so per-tile results are identical
    to the single-device multi-slice encode of the same geometry.

    Returns fn(y, u, v, qp, qp_c) of whole planes -> the
    FrameEncoder._encode_iframe_device dict with the symbol arrays gathered
    on the host (numpy) and each recon plane a list of row tiles."""
    rows_local = _tile_rows(mesh, height)
    encoders = [FrameEncoder(width, rows_local * 16, device=dev)
                for dev in mesh]
    recon_keys = ("recon_y", "recon_u", "recon_v")

    def fn(y, u, v, qp: int, qp_c: int):
        tiles = [split_tiles(p, mesh) for p in (y, u, v)]
        outs = [enc._encode_iframe_device(
            *(p[t].to(torch.int32) for p in tiles), qp, qp_c, deblock, i4x4)
            for t, enc in enumerate(encoders)]
        return {k: ([o[k] for o in outs] if k in recon_keys
                    else np.concatenate([o[k].cpu().numpy() for o in outs]))
                for k in outs[0]}

    return fn


def make_sharded_encode_cbr_fn(mesh, height: int, width: int,
                               cap_local: int, search_range: int = 8,
                               deblock: bool = True,
                               adaptive_qp: bool = False,
                               qp_min: int = 12, qp_max: int = 44):
    """Multi-device CBR P-run: the on-device rate-control loop of
    encoder.py:_encode_pbatch_cbr_device, tile-sharded. Per-tile EXACT bit
    counts are summed as integers into the shared virtual buffer, so one
    (qp_f, buf, cplx) carry, a set of 0-d float32 tensors on mesh[0] that
    the host never reads inside the run, drives every tile. With
    adaptive_qp, the fractional-QP dither runs on GLOBAL MB indices
    (mb0 = tile * n_mb_local), and each tile codes mb_qp_delta against its
    own slice QP (QP prediction resets per slice, spec 7.4.4).

    Returns fn(ys, us, vs, ry, ru, rv, qp0, buf0, cplx0, target) (frames
    and recon as lists of row tiles, the carry as floats or 0-d tensors,
    target a float) -> (streams (K, n, cap_local), bits (K, n), qps (K,),
    all on the host; the recon tiles; the final (qp_f, buf, cplx) 0-d
    tensors on mesh[0])."""
    n_dev = len(mesh)
    rows_local = _tile_rows(mesh, height)
    n_cols = width // 16
    n_mb_local = rows_local * n_cols
    f32, i32 = torch.float32, torch.int32
    # Deterministic stride-97 spread of the dither thresholds over the
    # picture's MB indices, cut into the tiles' shares.
    thresh = [((torch.arange(n_mb_local, dtype=i32, device=dev)
                + t * n_mb_local) * 97 % 128).to(f32) / 128.0
              for t, dev in enumerate(mesh)]

    def scalar(x):
        if torch.is_tensor(x):
            return x.to(mesh[0], f32)
        return torch.tensor(float(x), dtype=f32, device=mesh[0])

    def fn(ys, us, vs, ry, ru, rv, qp0, buf0, cplx0, target: float):
        recon = (list(ry), list(ru), list(rv))
        qp_f, buf, cplx = scalar(qp0), scalar(buf0), scalar(cplx0)
        streams, bits_out, qps = [], [], []
        for j in range(ys[0].shape[0]):
            adj_target = torch.clamp(target - 0.35 * buf, min=0.25 * target)
            want_qstep = torch.clamp(cplx / adj_target, 0.625, 1024.0)
            qp_f = torch.clamp(6.0 * torch.log2(want_qstep / 0.625),
                               float(qp_min), float(qp_max))
            if adaptive_qp:
                qp = torch.floor(qp_f).to(i32)
                frac = qp_f - qp.to(f32)
            else:
                qp = torch.clamp(torch.round(qp_f), qp_min, qp_max).to(i32)
            # Per tile: the frame's QP on the tile's device, and under
            # adaptive_qp the tile's share of the QP map.
            tile_qp, tile_map, enc_qps = [], [], []
            for t, dev in enumerate(mesh):
                qp_t = qp.to(dev)
                if adaptive_qp:
                    qp_map = torch.clamp(
                        qp_t + (thresh[t] < frac.to(dev)).to(i32), qp_min,
                        qp_max)
                    enc_qps.append((qp_map, chroma_qp_device(qp_map)))
                else:
                    qp_map = None
                    enc_qps.append((qp_t, chroma_qp_device(qp_t)))
                tile_qp.append(qp_t)
                tile_map.append(qp_map)
            outs = _pframe_cores(
                [[p[j] for p in planes] for planes in (ys, us, vs)], recon,
                enc_qps, search_range, rows_local, n_cols)
            recon = ([], [], [])
            streams.append([])
            bits_out.append([])
            for out, qp_t, qp_map in zip(outs, tile_qp, tile_map):
                mv, luma, cdc, cac = unpack_symbols_device(out["symbols"])
                stream, bits = pack_pslice_device(
                    mv, luma, cdc, cac, cap_local,
                    qp_map=(None if qp_map is None
                            else qp_map.reshape(rows_local, n_cols)),
                    slice_qp=qp_t)
                r2 = _recon(out)
                if deblock:
                    eff_map = None
                    if adaptive_qp:
                        coded = ((luma != 0).any(dim=3).any(dim=2)
                                 | (cdc != 0).any(dim=3).any(dim=2)
                                 | (cac != 0).any(dim=4).any(dim=3).any(dim=2))
                        eff_map = _last_coded(qp_map, coded.reshape(-1),
                                              qp_t).reshape(rows_local, n_cols)
                    r2 = deblock_pframe_from_symbols(
                        *r2, out["symbols"], qp_t, chroma_qp_device(qp_t),
                        rows_local, n_cols, qp_map=eff_map)
                for plane, tile in zip(recon, r2):
                    plane.append(tile)
                streams[-1].append(stream)
                bits_out[-1].append(bits)
            # Shared virtual buffer: integrate the FRAME's exact bits, the
            # tiles' counts summed as integers before the float32 update.
            bits_tot = torch.stack([b.to(mesh[0]) for b in bits_out[-1]]
                                   ).sum().to(f32)
            cplx = 0.75 * cplx + 0.25 * bits_tot * (
                0.625 * torch.exp2(qp_f / 6.0))
            buf = buf + bits_tot - target
            qps.append(qp)
        return (_download(streams), _download(bits_out),
                torch.stack(qps).cpu(), recon, (qp_f, buf, cplx))

    return fn


class ShardedEncoderSession:
    """Multi-device encoder session: num_slices == n_devices row tiles,
    each encoded end to end on its own device (the ni_rsrc multi-ASIC
    analog, SURVEY.md §2.3). IDR frames run tile-parallel with slice-local
    deblocking; P runs are the sharded loops above. Bitstreams are
    byte-identical to the equivalent single-device multi-slice session
    (num_slices=n, deblock_across_slices=False, entropy_mode="host";
    tests/test_torch_multislice.py, test_torch_sharding.py).

    devices: the tiles' devices in order (repeats allowed); else the first
    `n_devices` CUDA devices. Raises ValueError for cabac=True (the slice
    data is the device packer's CAVLC; the original writes it under a CABAC
    PPS, a stream that does not decode) and for lossless=True (the
    original's sharded run codes a lossy IDR + P stream). The base session,
    which writes headers and holds the counters and the rate state, lives
    on the first tile's device; `base.recon` holds the reference as a
    (y, u, v) triple of row tile lists."""

    def __init__(self, cfg, n_devices: int | None = None, devices=None):
        if cfg.cabac:
            raise ValueError("sharded sessions write CAVLC slice data; "
                             "cabac=True is not supported")
        if cfg.lossless:
            raise ValueError("sharded sessions code IDR + P pictures; "
                             "lossless=True is not supported")
        self.mesh = make_tile_mesh(n_devices, devices)
        n_dev = len(self.mesh)
        cfg = dataclasses.replace(cfg, num_slices=n_dev,
                                  deblock_across_slices=False,
                                  entropy_mode="host")
        self.base = EncoderSession(cfg, device=self.mesh[0])
        if len(self.base.slice_rows) != n_dev:
            raise ValueError("frame too short for one slice per device")
        self.cfg = cfg
        self._fn, self.rows_local, self.cap_local = make_sharded_encode_fn(
            self.mesh, self.base._pad_h, self.base._pad_w,
            deblock=cfg.deblock)
        self._cbr_fns: dict = {}  # cap_local -> CBR fn
        self._ifn = None

    def force_keyframe(self) -> None:
        self.base.force_keyframe()

    def _encode_idr_sharded(self, y, u, v) -> bytes:
        """IDR on the mesh: tile-parallel intra wavefront, then the base
        session's slice/NAL assembly from the gathered symbols."""
        base = self.base
        cfg = self.cfg
        if self._ifn is None:
            self._ifn = make_sharded_iframe_fn(
                self.mesh, base._pad_h, base._pad_w,
                deblock=cfg.deblock, i4x4=cfg.i4x4)
        qp_i = base._idr_qp()
        out = self._ifn(y, u, v, qp_i, int(chroma_qp(qp_i)))
        result = IFrameResult(
            mode16=out["mode16"], chroma_mode=out["chroma_mode"],
            dc_levels=out["dc_levels"], ac_levels=out["ac_levels"],
            cdc_levels=out["cdc_levels"], cac_levels=out["cac_levels"],
            recon_y=out["recon_y"],  # stays in row tiles on the mesh
            recon_u=out["recon_u"],
            recon_v=out["recon_v"],
            is_i4=out["is_i4"] if cfg.i4x4 else None,
            modes4=out["modes4"] if cfg.i4x4 else None,
            luma4_levels=out["luma4_levels"] if cfg.i4x4 else None,
        )
        return base._idr_au_from_result(result, qp_i)

    def _cbr_fn(self, cap_local: int):
        if cap_local not in self._cbr_fns:
            self._cbr_fns[cap_local] = make_sharded_encode_cbr_fn(
                self.mesh, self.base._pad_h, self.base._pad_w, cap_local,
                deblock=self.cfg.deblock, adaptive_qp=self.cfg.adaptive_qp)
        return self._cbr_fns[cap_local]

    def _pslice_aus_from_streams(self, streams_h, bits_h, k, qps=None):
        base = self.base
        n_cols = base.sps.pic_width_in_mbs
        out = []
        for j in range(k):
            qp = self.cfg.qp if qps is None else int(qps[j])
            au = b""
            for t, (r0, _r1) in enumerate(base.slice_rows):
                bw = base._pslice_header_writer(
                    qp, first_mb=r0 * n_cols, frame_idx=base.frame_idx)
                merge_slice_data(bw, streams_h[j, t], int(bits_h[j, t]))
                au += wrap_nal(H264NalType.SLICE, bw.get_bytes(),
                               nal_ref_idc=2)
            out.append(au)
            base.frame_idx += 1
        return out

    def encode_frame(self, i420) -> bytes:
        """Encode one I420 frame; returns its AU (encode_frames of one).
        The original has no encode_frame, so a session its API placed on
        the mesh failed every encode_one_frame."""
        return self.encode_frames([i420])[0]

    def encode_frames(self, i420_frames) -> list[bytes]:
        cfg = self.cfg
        base = self.base
        planes = []
        for buf in i420_frames:
            y, u, v = yuv.split_i420(buf, cfg.width, cfg.height)
            planes.append((yuv.pad_to_mb_grid(y, 16), yuv.pad_to_mb_grid(u, 8),
                           yuv.pad_to_mb_grid(v, 8)))
        out: list[bytes] = []
        i = 0
        while i < len(planes):
            idr_due = (base.frame_idx % cfg.gop_size == 0
                       or base.recon is None or base._force_idr)
            if idr_due:
                base._force_idr = False
                out.append(self._encode_idr_sharded(*planes[i]))
                base.frame_idx += 1
                i += 1
                continue
            until_idr = cfg.gop_size - (base.frame_idx % cfg.gop_size)
            k = min(len(planes) - i, until_idr)
            stacks = base._stack_host(planes[i : i + k])
            ys, us, vs = (split_tiles(s, self.mesh, axis=1) for s in stacks)
            prev_recon = base.recon
            if cfg.rc_mode == "cbr":
                out.extend(self._encode_p_run_cbr_sharded(ys, us, vs, k,
                                                          prev_recon))
                i += k
                continue
            qp = cfg.qp
            streams, bits, recon = self._fn(
                ys, us, vs, *prev_recon, qp, int(chroma_qp(qp)))
            base.recon = recon
            if int(bits.max()) > self.cap_local * 32:
                # Per-tile budget exceeded: fall back (don't raise) to the
                # single-device multi-slice host path for this chunk — the
                # compute math is identical, so recon/bitstream agree.
                symbols, recon = base._frame_encoder.encode_pframes_batch(
                    *stacks, *(gather_tiles(p, self.mesh[0])
                               for p in prev_recon), qp, deblock=cfg.deblock)
                base.recon = tuple(split_tiles(p, self.mesh) for p in recon)
                for j in range(k):
                    out.append(base._pslice_au(unpack_symbols(symbols[j])))
                    base.frame_idx += 1
                i += k
                continue
            out.extend(self._pslice_aus_from_streams(streams, bits, k))
            i += k
        return out

    def _encode_p_run_cbr_sharded(self, ys, us, vs, k, prev_recon):
        """CBR P run on the mesh: exact per-frame bits summed into the
        shared virtual buffer inside the device loop. On per-tile cap
        overflow, retries the run at a doubled cap (same initial state =>
        identical output)."""
        base = self.base
        st = base.rc_state
        cap = self.cap_local
        while True:
            fn = self._cbr_fn(cap)
            streams, bits, qps, recon, (qp_f, buf, cplx) = fn(
                ys, us, vs, *prev_recon, st["qp"], st["buf"], st["cplx"],
                float(base._rc_target))
            if int(bits.max()) <= cap * 32:
                break
            cap *= 2
            if cap > base._pad_w * base._pad_h:  # hard stop: ~21 bpp
                raise RuntimeError("CBR tile stream exceeded any budget")
        base.recon = recon
        base.rc_state = {"qp": float(qp_f), "buf": float(buf),
                         "cplx": float(cplx)}
        return self._pslice_aus_from_streams(streams, bits, k, qps=qps)

    @property
    def recon(self):
        """The reference planes, gathered on the first tile's device (None
        before the first IDR)."""
        if self.base.recon is None:
            return None
        return tuple(gather_tiles(p, self.mesh[0]) for p in self.base.recon)
