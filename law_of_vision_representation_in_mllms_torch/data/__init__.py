"""Host-side data: conversation templates, tokenization and label masking,
image preprocessing, training datasets and collation (framework-free; PIL is
imported only where an image is decoded)."""

from .conversation import CONV_TEMPLATES, Conversation, get_template
from .datasets import (FeatureDataset, SupervisedDataset, collate_batch,
                       length_grouped_indices)
from .image_processing import (ImageProcessorConfig, preprocess_image,
                               processor_for_tower)
from .preprocess import (SimpleTokenizer, preprocess_sources,
                         tokenizer_image_token)

__all__ = ["CONV_TEMPLATES", "Conversation", "get_template",
           "FeatureDataset", "SupervisedDataset", "collate_batch",
           "length_grouped_indices", "ImageProcessorConfig",
           "preprocess_image", "processor_for_tower", "SimpleTokenizer",
           "preprocess_sources", "tokenizer_image_token"]
