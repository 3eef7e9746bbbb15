"""Host-side data: conversation templates, tokenization, image
preprocessing (framework-free; PIL is imported only where an image is
decoded)."""

from .conversation import CONV_TEMPLATES, Conversation, get_template
from .image_processing import (ImageProcessorConfig, preprocess_image,
                               processor_for_tower)
from .preprocess import SimpleTokenizer, tokenizer_image_token

__all__ = ["CONV_TEMPLATES", "Conversation", "get_template",
           "ImageProcessorConfig", "preprocess_image", "processor_for_tower",
           "SimpleTokenizer", "tokenizer_image_token"]
