from .errors import DecoderRetCode, EncoderRetCode  # noqa: F401
from .encoder_api import VideoEncoder, create_video_encoder, destroy_video_encoder  # noqa: F401
from .decoder_api import VideoDecoder, create_video_decoder, destroy_video_decoder  # noqa: F401
