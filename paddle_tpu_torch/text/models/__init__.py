"""Model zoo (counterpart of paddle_tpu/text/models)."""
from .gpt import (GPTConfig, GPTDecoderLayer, GPTForCausalLM,  # noqa: F401
                  GPTModel, GPTPretrainingCriterion, gpt_1p3b, gpt_medium,
                  gpt_small, gpt_tiny)
from .bert import (  # noqa: F401
    BertConfig,
    BertForPretraining,
    BertForSequenceClassification,
    BertModel,
    BertPretrainingCriterion,
    ErnieForPretraining,
    ErnieModel,
    bert_base,
    bert_tiny,
    ernie_3_base,
)

__all__ = [
    "GPTConfig", "GPTDecoderLayer", "GPTModel", "GPTForCausalLM",
    "GPTPretrainingCriterion", "gpt_tiny", "gpt_small", "gpt_medium",
    "gpt_1p3b",
    "BertConfig", "BertModel", "BertForPretraining",
    "BertPretrainingCriterion", "BertForSequenceClassification",
    "ErnieModel", "ErnieForPretraining", "bert_tiny", "bert_base",
    "ernie_3_base",
]
