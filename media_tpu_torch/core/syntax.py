"""H.264 high-level syntax: SPS, PPS, slice headers (write + parse).

Covers the baseline/constrained-baseline subset the framework's encoder emits
(frame_mbs_only, no field coding, POC type 2, CAVLC first) while parsing a
slightly wider envelope on the decode side. Spec references are to
Rec. ITU-T H.264 (06/2019) section numbers.

The capability envelope mirrors the reference adapters (SURVEY.md §5-config):
W/H in [16, 4096] for the software path, fps/gop/bitrate validated by the
config layer, profiles baseline/main/high (profile_idc 66/77/100 — reference:
video_codec/VideoEncoderNetint.cpp:97-100).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bitstream import BitReader, BitWriter

PROFILE_BASELINE = 66
PROFILE_MAIN = 77
PROFILE_HIGH = 100

# "baseline/main/high" -> profile_idc, as the reference translates string
# profiles to IDC values (VideoEncoderNetint.cpp:97-100).
PROFILE_BY_NAME = {
    "baseline": PROFILE_BASELINE,
    "main": PROFILE_MAIN,
    "high": PROFILE_HIGH,
}

SLICE_TYPE_P = 0
SLICE_TYPE_B = 1
SLICE_TYPE_I = 2


@dataclass
class SPS:
    """seq_parameter_set_rbsp (spec 7.3.2.1.1), frame_mbs_only subset."""

    profile_idc: int = PROFILE_BASELINE
    constraint_set_flags: int = 0  # constraint_set0..5 packed, bit0 = set0
    level_idc: int = 31
    seq_parameter_set_id: int = 0
    log2_max_frame_num: int = 8
    pic_order_cnt_type: int = 2
    log2_max_pic_order_cnt_lsb: int = 8  # used when pic_order_cnt_type == 0
    max_num_ref_frames: int = 1
    gaps_in_frame_num_allowed: bool = False
    pic_width_in_mbs: int = 0
    pic_height_in_mbs: int = 0
    frame_mbs_only: bool = True
    direct_8x8_inference: bool = True
    crop_left: int = 0
    crop_right: int = 0
    crop_top: int = 0
    crop_bottom: int = 0
    # VUI timing (E.2.1): (num_units_in_tick, time_scale) or None. Frame rate
    # = time_scale / (2 * num_units_in_tick). The reference signals fps only
    # via vendor params (VideoEncoderOpenH264.cpp:237 fMaxFrameRate); here it
    # is carried in-band so any conformant decoder recovers it.
    vui_timing: tuple | None = None
    fixed_frame_rate: bool = True

    @property
    def width(self) -> int:
        return self.pic_width_in_mbs * 16 - 2 * (self.crop_left + self.crop_right)

    @property
    def height(self) -> int:
        return self.pic_height_in_mbs * 16 - 2 * (self.crop_top + self.crop_bottom)

    @classmethod
    def for_size(cls, width: int, height: int, **kw) -> "SPS":
        """SPS for a given luma size; odd sizes get a conformance crop window
        (the analogue of the reference's alignment compensation,
        VideoEncoderNetint.cpp:207-209,359-370)."""
        wmb = (width + 15) // 16
        hmb = (height + 15) // 16
        return cls(
            pic_width_in_mbs=wmb,
            pic_height_in_mbs=hmb,
            crop_right=(wmb * 16 - width) // 2,
            crop_bottom=(hmb * 16 - height) // 2,
            **kw,
        )

    def write(self, w: BitWriter) -> None:
        w.u(8, self.profile_idc)
        w.u(8, self.constraint_set_flags)
        w.u(8, self.level_idc)
        w.ue(self.seq_parameter_set_id)
        if self.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128):
            w.ue(1)  # chroma_format_idc = 4:2:0
            w.ue(0)  # bit_depth_luma_minus8
            w.ue(0)  # bit_depth_chroma_minus8
            w.flag(False)  # qpprime_y_zero_transform_bypass_flag
            w.flag(False)  # seq_scaling_matrix_present_flag
        w.ue(self.log2_max_frame_num - 4)
        w.ue(self.pic_order_cnt_type)
        if self.pic_order_cnt_type == 0:
            w.ue(self.log2_max_pic_order_cnt_lsb - 4)
        elif self.pic_order_cnt_type == 1:
            raise NotImplementedError("pic_order_cnt_type 1 not emitted")
        w.ue(self.max_num_ref_frames)
        w.flag(self.gaps_in_frame_num_allowed)
        w.ue(self.pic_width_in_mbs - 1)
        w.ue(self.pic_height_in_mbs - 1)
        w.flag(self.frame_mbs_only)
        if not self.frame_mbs_only:
            raise NotImplementedError("interlace (field coding) not emitted")
        w.flag(self.direct_8x8_inference)
        cropping = bool(self.crop_left or self.crop_right or self.crop_top or self.crop_bottom)
        w.flag(cropping)
        if cropping:
            w.ue(self.crop_left)
            w.ue(self.crop_right)
            w.ue(self.crop_top)
            w.ue(self.crop_bottom)
        w.flag(self.vui_timing is not None)  # vui_parameters_present_flag
        if self.vui_timing is not None:
            # vui_parameters (E.1.1): timing info only.
            w.flag(False)  # aspect_ratio_info_present_flag
            w.flag(False)  # overscan_info_present_flag
            w.flag(False)  # video_signal_type_present_flag
            w.flag(False)  # chroma_loc_info_present_flag
            w.flag(True)  # timing_info_present_flag
            num_units, time_scale = self.vui_timing
            w.u(32, num_units)
            w.u(32, time_scale)
            w.flag(self.fixed_frame_rate)
            w.flag(False)  # nal_hrd_parameters_present_flag
            w.flag(False)  # vcl_hrd_parameters_present_flag
            w.flag(False)  # pic_struct_present_flag
            w.flag(False)  # bitstream_restriction_flag

    @classmethod
    def parse(cls, r: BitReader) -> "SPS":
        s = cls()
        s.profile_idc = r.u(8)
        s.constraint_set_flags = r.u(8)
        s.level_idc = r.u(8)
        s.seq_parameter_set_id = r.ue()
        if s.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128):
            chroma_format_idc = r.ue()
            if chroma_format_idc == 3:
                r.flag()  # separate_colour_plane_flag
            r.ue()  # bit_depth_luma_minus8
            r.ue()  # bit_depth_chroma_minus8
            r.flag()  # qpprime_y_zero_transform_bypass_flag
            if r.flag():
                raise NotImplementedError("scaling matrices not supported")
        s.log2_max_frame_num = r.ue() + 4
        s.pic_order_cnt_type = r.ue()
        if s.pic_order_cnt_type == 0:
            s.log2_max_pic_order_cnt_lsb = r.ue() + 4
        elif s.pic_order_cnt_type == 1:
            raise NotImplementedError("pic_order_cnt_type 1 not supported")
        s.max_num_ref_frames = r.ue()
        s.gaps_in_frame_num_allowed = r.flag()
        s.pic_width_in_mbs = r.ue() + 1
        s.pic_height_in_mbs = r.ue() + 1
        s.frame_mbs_only = r.flag()
        if not s.frame_mbs_only:
            r.flag()  # mb_adaptive_frame_field_flag
        s.direct_8x8_inference = r.flag()
        if r.flag():  # frame_cropping_flag
            s.crop_left = r.ue()
            s.crop_right = r.ue()
            s.crop_top = r.ue()
            s.crop_bottom = r.ue()
        if r.flag():  # vui_parameters_present_flag (E.1.1; timing subset)
            if r.flag():  # aspect_ratio_info_present_flag
                if r.u(8) == 255:  # Extended_SAR
                    r.u(16)
                    r.u(16)
            if r.flag():  # overscan_info_present_flag
                r.flag()
            if r.flag():  # video_signal_type_present_flag
                r.u(3)
                r.flag()
                if r.flag():  # colour_description_present_flag
                    r.u(8), r.u(8), r.u(8)
            if r.flag():  # chroma_loc_info_present_flag
                r.ue(), r.ue()
            if r.flag():  # timing_info_present_flag
                num_units = r.u(32)
                time_scale = r.u(32)
                s.vui_timing = (num_units, time_scale)
                s.fixed_frame_rate = r.flag()
            # HRD / pic_struct / bitstream restriction not parsed further;
            # byte-aligned trailing bits absorb the remainder.
        return s


@dataclass
class PPS:
    """pic_parameter_set_rbsp (spec 7.3.2.2)."""

    pic_parameter_set_id: int = 0
    seq_parameter_set_id: int = 0
    entropy_coding_mode: int = 0  # 0 = CAVLC, 1 = CABAC
    pic_init_qp: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present: bool = True
    constrained_intra_pred: bool = False
    num_ref_idx_l0_active: int = 1
    num_ref_idx_l1_active: int = 1

    def write(self, w: BitWriter) -> None:
        w.ue(self.pic_parameter_set_id)
        w.ue(self.seq_parameter_set_id)
        w.flag(self.entropy_coding_mode)
        w.flag(False)  # bottom_field_pic_order_in_frame_present_flag
        w.ue(0)  # num_slice_groups_minus1
        w.ue(self.num_ref_idx_l0_active - 1)
        w.ue(self.num_ref_idx_l1_active - 1)
        w.flag(False)  # weighted_pred_flag
        w.u(2, 0)  # weighted_bipred_idc
        w.se(self.pic_init_qp - 26)
        w.se(0)  # pic_init_qs_minus26
        w.se(self.chroma_qp_index_offset)
        w.flag(self.deblocking_filter_control_present)
        w.flag(self.constrained_intra_pred)
        w.flag(False)  # redundant_pic_cnt_present_flag

    @classmethod
    def parse(cls, r: BitReader) -> "PPS":
        p = cls()
        p.pic_parameter_set_id = r.ue()
        p.seq_parameter_set_id = r.ue()
        p.entropy_coding_mode = int(r.flag())
        r.flag()  # bottom_field_pic_order_in_frame_present_flag
        if r.ue() != 0:
            raise NotImplementedError("slice groups (FMO) not supported")
        p.num_ref_idx_l0_active = r.ue() + 1
        p.num_ref_idx_l1_active = r.ue() + 1
        if r.flag():
            raise NotImplementedError("weighted prediction not supported")
        r.u(2)  # weighted_bipred_idc
        p.pic_init_qp = r.se() + 26
        r.se()  # pic_init_qs_minus26
        p.chroma_qp_index_offset = r.se()
        p.deblocking_filter_control_present = r.flag()
        p.constrained_intra_pred = r.flag()
        if r.flag():
            raise NotImplementedError("redundant_pic_cnt not supported")
        return p


# --------------------------------------------------------------------- SEI

SEI_RECOVERY_POINT = 6
SEI_USER_DATA_UNREGISTERED = 5

# 16-byte uuid_iso_iec_11578 identifying this framework's user-data SEI.
MEDIA_TPU_SEI_UUID = bytes.fromhex("9d3c1a6e54f14b0bb2a7c8a1d0e2f347")


def write_sei_rbsp(messages: list) -> bytes:
    """sei_rbsp (7.3.2.3): list of (payload_type, payload bytes)."""
    out = bytearray()
    for ptype, payload in messages:
        t = ptype
        while t >= 255:
            out.append(255)
            t -= 255
        out.append(t)
        n = len(payload)
        while n >= 255:
            out.append(255)
            n -= 255
        out.append(n)
        out += payload
    out.append(0x80)  # rbsp_trailing_bits (SEI payloads are byte counts)
    return bytes(out)


def parse_sei_rbsp(rbsp: bytes) -> list:
    """Returns [(payload_type, payload bytes), ...]."""
    msgs = []
    i = 0
    while i < len(rbsp) and rbsp[i] != 0x80:
        ptype = 0
        while i < len(rbsp) and rbsp[i] == 255:
            ptype += 255
            i += 1
        if i >= len(rbsp):
            break
        ptype += rbsp[i]
        i += 1
        size = 0
        while i < len(rbsp) and rbsp[i] == 255:
            size += 255
            i += 1
        if i >= len(rbsp):
            break
        size += rbsp[i]
        i += 1
        msgs.append((ptype, rbsp[i : i + size]))
        i += size
    return msgs


def sei_recovery_point(recovery_frame_cnt: int = 0) -> tuple:
    """recovery_point SEI (D.1.8): marks a gradual/exact refresh point."""
    w = BitWriter()
    w.ue(recovery_frame_cnt)
    w.flag(True)  # exact_match_flag
    w.flag(False)  # broken_link_flag
    w.u(2, 0)  # changing_slice_group_idc
    w.rbsp_trailing_bits()
    return (SEI_RECOVERY_POINT, w.get_bytes())


def sei_user_data(text: bytes, uuid: bytes = MEDIA_TPU_SEI_UUID) -> tuple:
    """user_data_unregistered SEI (D.1.7)."""
    return (SEI_USER_DATA_UNREGISTERED, uuid + text)


def write_aud_rbsp(primary_pic_type: int) -> bytes:
    """access_unit_delimiter_rbsp (7.3.2.4). 0 = I only, 1 = I+P."""
    w = BitWriter()
    w.u(3, primary_pic_type)
    w.rbsp_trailing_bits()
    return w.get_bytes()


@dataclass
class SliceHeader:
    """slice_header (spec 7.3.3), baseline subset: I and P frame slices."""

    first_mb_in_slice: int = 0
    slice_type: int = SLICE_TYPE_I  # 0..4 or the +5 "all slices same" variants
    pic_parameter_set_id: int = 0
    frame_num: int = 0
    idr: bool = False
    idr_pic_id: int = 0
    pic_order_cnt_lsb: int = 0
    direct_spatial_mv_pred: bool = True
    num_ref_idx_active_override: bool = False
    num_ref_idx_l0_active: int = 1
    num_ref_idx_l1_active: int = 1
    slice_qp_delta: int = 0
    disable_deblocking_filter_idc: int = 0
    cabac_init_idc: int = 0
    slice_alpha_c0_offset_div2: int = 0
    slice_beta_offset_div2: int = 0
    nal_ref_idc: int = 3

    @property
    def slice_type_mod5(self) -> int:
        return self.slice_type % 5

    @property
    def is_p(self) -> bool:
        return self.slice_type_mod5 == SLICE_TYPE_P

    @property
    def is_b(self) -> bool:
        return self.slice_type_mod5 == SLICE_TYPE_B

    @property
    def is_i(self) -> bool:
        return self.slice_type_mod5 == SLICE_TYPE_I

    def write(self, w: BitWriter, sps: SPS, pps: PPS) -> None:
        w.ue(self.first_mb_in_slice)
        w.ue(self.slice_type)
        w.ue(self.pic_parameter_set_id)
        w.u(sps.log2_max_frame_num, self.frame_num)
        if self.idr:
            w.ue(self.idr_pic_id)
        if sps.pic_order_cnt_type == 0:
            w.u(sps.log2_max_pic_order_cnt_lsb, self.pic_order_cnt_lsb)
        if self.is_b:
            w.flag(self.direct_spatial_mv_pred)
        if self.is_p or self.is_b:
            w.flag(self.num_ref_idx_active_override)
            if self.num_ref_idx_active_override:
                w.ue(self.num_ref_idx_l0_active - 1)
                if self.is_b:
                    w.ue(self.num_ref_idx_l1_active - 1)
            w.flag(False)  # ref_pic_list_modification_flag_l0
            if self.is_b:
                w.flag(False)  # ref_pic_list_modification_flag_l1
        if self.nal_ref_idc != 0:
            # dec_ref_pic_marking (7.3.3.3)
            if self.idr:
                w.flag(False)  # no_output_of_prior_pics_flag
                w.flag(False)  # long_term_reference_flag
            else:
                w.flag(False)  # adaptive_ref_pic_marking_mode_flag
        if pps.entropy_coding_mode and not self.is_i:
            w.ue(self.cabac_init_idc)
        w.se(self.slice_qp_delta)
        if pps.deblocking_filter_control_present:
            w.ue(self.disable_deblocking_filter_idc)
            if self.disable_deblocking_filter_idc != 1:
                w.se(self.slice_alpha_c0_offset_div2)
                w.se(self.slice_beta_offset_div2)

    @classmethod
    def parse(cls, r: BitReader, sps: SPS, pps: PPS, *, nal_type: int,
              nal_ref_idc: int) -> "SliceHeader":
        h = cls()
        h.idr = nal_type == 5
        h.nal_ref_idc = nal_ref_idc
        h.first_mb_in_slice = r.ue()
        h.slice_type = r.ue()
        if h.slice_type_mod5 not in (SLICE_TYPE_I, SLICE_TYPE_P,
                                     SLICE_TYPE_B):
            raise NotImplementedError(f"slice_type {h.slice_type} not supported")
        h.pic_parameter_set_id = r.ue()
        h.frame_num = r.u(sps.log2_max_frame_num)
        if h.idr:
            h.idr_pic_id = r.ue()
        if sps.pic_order_cnt_type == 0:
            h.pic_order_cnt_lsb = r.u(sps.log2_max_pic_order_cnt_lsb)
        h.num_ref_idx_l0_active = pps.num_ref_idx_l0_active
        h.num_ref_idx_l1_active = pps.num_ref_idx_l1_active
        if h.is_b:
            h.direct_spatial_mv_pred = r.flag()
        if h.is_p or h.is_b:
            h.num_ref_idx_active_override = r.flag()
            if h.num_ref_idx_active_override:
                h.num_ref_idx_l0_active = r.ue() + 1
                if h.is_b:
                    h.num_ref_idx_l1_active = r.ue() + 1
            if r.flag():
                raise NotImplementedError("ref_pic_list_modification not supported")
            if h.is_b and r.flag():
                raise NotImplementedError("ref_pic_list_modification not supported")
        if nal_ref_idc != 0:
            if h.idr:
                r.flag()  # no_output_of_prior_pics_flag
                if r.flag():
                    raise NotImplementedError("long-term reference not supported")
            else:
                if r.flag():
                    raise NotImplementedError("adaptive ref pic marking not supported")
        if pps.entropy_coding_mode and not h.is_i:
            h.cabac_init_idc = r.ue()
        h.slice_qp_delta = r.se()
        if pps.deblocking_filter_control_present:
            h.disable_deblocking_filter_idc = r.ue()
            if h.disable_deblocking_filter_idc != 1:
                h.slice_alpha_c0_offset_div2 = r.se()
                h.slice_beta_offset_div2 = r.se()
        return h
