"""Model-wide constants.

Behavioral contract mirrors the reference (``omchat/constants.py``):
the ``-200`` image sentinel, ``-100`` label-ignore index, and the ChatML special
tokens used by OmChat's Qwen2 tokenizer.
"""

# Label index ignored by the loss (reference: omchat/constants.py:7).
IGNORE_INDEX = -100
# Sentinel token id spliced into input_ids wherever an image tile's features go
# (reference: omchat/constants.py:8).
IMAGE_TOKEN_INDEX = -200

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"

# ChatML ids hardcoded by the reference for the Qwen2 tokenizer
# (reference: omchat/make_context.py:79-80).
IM_START_TOKEN_ID = 151644  # <|im_start|>
IM_END_TOKEN_ID = 151645  # <|im_end|>
# EOS id used by every live generation entry point
# (reference: single_inference.py:61, cli.py:69).
EOS_TOKEN_ID = 151645

# ChatML prompt-history budget (reference: omchat/make_context.py:71).
MAX_WINDOW_SIZE = 6144

# ImageNet normalization used by every live image path
# (reference: internVIT_encoder.py:26-29, omchat/hf/image_processing_omchat.py:187-188).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# anyres grid pinpoints shipped with the HF checkpoint family
# (reference: omchat/hf/image_processing_omchat.py:195-199).
DEFAULT_GRID_PINPOINTS = (
    (448, 896),
    (896, 448),
    (896, 896),
    (1344, 448),
    (448, 1344),
    (1344, 1344),
)
