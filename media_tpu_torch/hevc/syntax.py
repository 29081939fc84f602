"""HEVC NAL layer and parameter-set syntax (Rec. ITU-T H.265 7.3.1-7.3.2).

Covers the fixed configuration the intra-only skeleton emits: Main profile,
4:2:0 8-bit, one layer/sub-layer, CTU == min CB == 16 (so no coding-quadtree
split flags), min TB == max TB == 4 (so transform splits are inferred, no
split_transform_flag bins), SAO/tiles/WPP/scaling lists off, deblocking
disabled via PPS. Writers and parsers are exact mirrors.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.bitstream import BitReader, BitWriter
from ..core.nal import escape_rbsp, unescape_rbsp

# nal_unit_type values (Table 7-1)
NAL_IDR_W_RADL = 19
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34


def wrap_hevc_nal(nal_type: int, rbsp: bytes, temporal_id: int = 0) -> bytes:
    """Annex-B start code + 2-byte HEVC NAL header + escaped RBSP."""
    header = bytes([(nal_type & 0x3F) << 1, 1 + temporal_id])
    return b"\x00\x00\x00\x01" + header[0:1] + header[1:2] + escape_rbsp(rbsp)


def parse_hevc_nals(data: bytes):
    """Yield (nal_type, rbsp) from an Annex-B HEVC stream."""
    from ..core.nal import find_start_code

    pos, sc = find_start_code(data, 0)
    while pos != -1:
        start = pos + sc
        nxt, nsc = find_start_code(data, start)
        end = nxt if nxt != -1 else len(data)
        if end - start >= 2:
            nal_type = (data[start] >> 1) & 0x3F
            yield nal_type, unescape_rbsp(data[start + 2 : end])
        pos, sc = nxt, nsc


def _write_ptl(w: BitWriter) -> None:
    """profile_tier_level (7.3.3): Main profile, main tier, level 4.0."""
    w.u(2, 0)  # general_profile_space
    w.u(1, 0)  # general_tier_flag
    w.u(5, 1)  # general_profile_idc = Main
    w.u(32, 1 << 30)  # compatibility flags: bit 1 (Main)
    w.u(1, 1)  # progressive_source
    w.u(1, 0)  # interlaced_source
    w.u(1, 1)  # non_packed_constraint
    w.u(1, 1)  # frame_only_constraint
    w.u(32, 0)  # general_reserved_zero_43bits (43 = 32 + 11)
    w.u(11, 0)
    w.u(1, 0)  # general_inbld_flag / reserved
    w.u(8, 120)  # general_level_idc = 4.0


def _parse_ptl(r: BitReader) -> dict:
    out = {"profile_space": r.u(2), "tier": r.u(1), "profile_idc": r.u(5)}
    r.u(32)  # compat
    r.u(4)  # progressive/interlaced/non_packed/frame_only
    r.u(32)
    r.u(11)
    r.u(1)
    out["level_idc"] = r.u(8)
    return out


@dataclass
class HevcVPS:
    vps_id: int = 0

    def write(self, w: BitWriter) -> None:
        w.u(4, self.vps_id)
        w.u(1, 1)  # base_layer_internal_flag
        w.u(1, 1)  # base_layer_available_flag
        w.u(6, 0)  # max_layers_minus1
        w.u(3, 0)  # max_sub_layers_minus1
        w.u(1, 1)  # temporal_id_nesting
        w.u(16, 0xFFFF)  # reserved
        _write_ptl(w)
        w.u(1, 1)  # sub_layer_ordering_info_present
        w.ue(1)  # max_dec_pic_buffering_minus1
        w.ue(0)  # num_reorder_pics
        w.ue(0)  # max_latency_increase
        w.u(6, 0)  # max_layer_id
        w.ue(0)  # num_layer_sets_minus1
        w.u(1, 0)  # timing_info_present
        w.u(1, 0)  # vps_extension

    @classmethod
    def parse(cls, r: BitReader) -> "HevcVPS":
        v = cls(vps_id=r.u(4))
        r.u(1), r.u(1), r.u(6), r.u(3), r.u(1), r.u(16)
        _parse_ptl(r)
        if r.u(1):
            r.ue(), r.ue(), r.ue()
        r.u(6)
        r.ue()
        r.u(1)
        r.u(1)
        return v


@dataclass
class HevcSPS:
    sps_id: int = 0
    vps_id: int = 0
    width: int = 0  # luma samples (multiple of 16 in this skeleton)
    height: int = 0
    conf_right: int = 0  # conformance window crops, in chroma units
    conf_bottom: int = 0

    def write(self, w: BitWriter) -> None:
        w.u(4, self.vps_id)
        w.u(3, 0)  # max_sub_layers_minus1
        w.u(1, 1)  # temporal_id_nesting
        _write_ptl(w)
        w.ue(self.sps_id)
        w.ue(1)  # chroma_format_idc = 4:2:0
        w.ue(self.width)
        w.ue(self.height)
        if self.conf_right or self.conf_bottom:
            w.u(1, 1)
            w.ue(0)
            w.ue(self.conf_right)
            w.ue(0)
            w.ue(self.conf_bottom)
        else:
            w.u(1, 0)
        w.ue(0)  # bit_depth_luma_minus8
        w.ue(0)  # bit_depth_chroma_minus8
        w.ue(4)  # log2_max_pic_order_cnt_lsb_minus4
        w.u(1, 1)  # sub_layer_ordering_info_present
        w.ue(1)  # max_dec_pic_buffering_minus1
        w.ue(0)  # num_reorder
        w.ue(0)  # max_latency
        w.ue(1)  # log2_min_luma_coding_block_size_minus3  (min CB 16)
        w.ue(0)  # log2_diff_max_min_luma_coding_block_size (CTU 16)
        w.ue(0)  # log2_min_luma_transform_block_size_minus2 (min TB 4)
        w.ue(0)  # log2_diff_max_min_luma_transform_block_size (max TB 4)
        w.ue(0)  # max_transform_hierarchy_depth_inter
        w.ue(2)  # max_transform_hierarchy_depth_intra (16 -> 4 inferred)
        w.u(1, 0)  # scaling_list_enabled
        w.u(1, 0)  # amp_enabled
        w.u(1, 0)  # sample_adaptive_offset_enabled
        w.u(1, 0)  # pcm_enabled
        w.ue(0)  # num_short_term_ref_pic_sets
        w.u(1, 0)  # long_term_ref_pics_present
        w.u(1, 0)  # sps_temporal_mvp_enabled
        w.u(1, 0)  # strong_intra_smoothing
        w.u(1, 0)  # vui_parameters_present
        w.u(1, 0)  # sps_extension

    @classmethod
    def parse(cls, r: BitReader) -> "HevcSPS":
        s = cls()
        s.vps_id = r.u(4)
        r.u(3)
        r.u(1)
        _parse_ptl(r)
        s.sps_id = r.ue()
        chroma = r.ue()
        assert chroma == 1, "skeleton parses 4:2:0 only"
        s.width = r.ue()
        s.height = r.ue()
        if r.u(1):
            r.ue()
            s.conf_right = r.ue()
            r.ue()
            s.conf_bottom = r.ue()
        r.ue(), r.ue(), r.ue()
        if r.u(1):
            r.ue(), r.ue(), r.ue()
        min_cb = r.ue()
        diff_cb = r.ue()
        assert (min_cb, diff_cb) == (1, 0), "skeleton: CTU == min CB == 16"
        r.ue(), r.ue(), r.ue(), r.ue()
        assert r.u(1) == 0  # scaling lists
        r.u(1)
        assert r.u(1) == 0  # SAO
        assert r.u(1) == 0  # PCM
        assert r.ue() == 0  # st ref pic sets
        r.u(1), r.u(1), r.u(1)
        r.u(1)  # vui
        r.u(1)  # ext
        return s


@dataclass
class HevcPPS:
    pps_id: int = 0
    sps_id: int = 0
    init_qp: int = 26

    def write(self, w: BitWriter) -> None:
        w.ue(self.pps_id)
        w.ue(self.sps_id)
        w.u(1, 0)  # dependent_slice_segments_enabled
        w.u(1, 0)  # output_flag_present
        w.u(3, 0)  # num_extra_slice_header_bits
        w.u(1, 0)  # sign_data_hiding
        w.u(1, 0)  # cabac_init_present
        w.ue(0)  # num_ref_idx_l0_default_active_minus1
        w.ue(0)  # l1
        w.se(self.init_qp - 26)
        w.u(1, 0)  # constrained_intra_pred
        w.u(1, 0)  # transform_skip
        w.u(1, 0)  # cu_qp_delta_enabled
        w.se(0)  # cb_qp_offset
        w.se(0)  # cr_qp_offset
        w.u(1, 0)  # slice_chroma_qp_offsets_present
        w.u(1, 0)  # weighted_pred
        w.u(1, 0)  # weighted_bipred
        w.u(1, 0)  # transquant_bypass
        w.u(1, 0)  # tiles_enabled
        w.u(1, 0)  # entropy_coding_sync
        w.u(1, 1)  # loop_filter_across_slices
        w.u(1, 1)  # deblocking_filter_control_present
        w.u(1, 0)  # deblocking_filter_override_enabled
        w.u(1, 1)  # pps_deblocking_filter_disabled (skeleton: no deblock)
        w.u(1, 0)  # scaling_list_data_present
        w.u(1, 0)  # lists_modification_present
        w.ue(0)  # log2_parallel_merge_level_minus2
        w.u(1, 0)  # slice_segment_header_extension
        w.u(1, 0)  # pps_extension

    @classmethod
    def parse(cls, r: BitReader) -> "HevcPPS":
        p = cls()
        p.pps_id = r.ue()
        p.sps_id = r.ue()
        r.u(1), r.u(1), r.u(3), r.u(1), r.u(1)
        r.ue(), r.ue()
        p.init_qp = r.se() + 26
        r.u(1), r.u(1)
        assert r.u(1) == 0  # cu_qp_delta
        r.se(), r.se()
        r.u(1), r.u(1), r.u(1), r.u(1), r.u(1), r.u(1), r.u(1)
        if r.u(1):  # deblocking_filter_control_present
            r.u(1)  # override enabled
            r.u(1)  # pps disabled
        r.u(1), r.u(1)
        r.ue()
        r.u(1), r.u(1)
        return p


def write_slice_header(w: BitWriter, pps_id: int, qp: int,
                       init_qp: int) -> None:
    """IDR_W_RADL slice segment header (7.3.6.1) for the skeleton config."""
    w.u(1, 1)  # first_slice_segment_in_pic
    w.u(1, 0)  # no_output_of_prior_pics (IRAP)
    w.ue(pps_id)
    w.ue(2)  # slice_type = I
    w.se(qp - init_qp)  # slice_qp_delta
    # byte_alignment(): stop bit + zeros
    w.u(1, 1)
    while not w.byte_aligned():
        w.u(1, 0)


def parse_slice_header(r: BitReader) -> dict:
    first = r.u(1)
    r.u(1)
    pps_id = r.ue()
    slice_type = r.ue()
    qp_delta = r.se()
    r.u(1)  # alignment stop bit
    while not r.byte_aligned():
        r.u(1)
    return {"first": first, "pps_id": pps_id, "slice_type": slice_type,
            "qp_delta": qp_delta, "bitpos": r.bit_position}
