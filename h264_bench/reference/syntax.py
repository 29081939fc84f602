"""H.264 high-level syntax writers: SPS, PPS and slice headers (spec
7.3.2.1.1, 7.3.2.2, 7.3.3), the baseline subset the encoder emits
(frame_mbs_only, POC type 2). A frozen copy of
media_tpu_torch/core/syntax.py's writers."""

from __future__ import annotations

from dataclasses import dataclass

from .bitstream import BitWriter

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



# --------------------------------------------------------------------- SEI

SEI_RECOVERY_POINT = 6
SEI_USER_DATA_UNREGISTERED = 5


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

