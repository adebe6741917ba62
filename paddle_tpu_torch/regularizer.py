"""Weight-decay regularizers (counterpart of paddle_tpu/regularizer.py,
the port's own copy).

Coefficient carriers, as in the reference: the optimizer folds a
parameter's `regularizer._coeff` into its update as coupled L2
(`g + coeff * p`; decoupled for AdamW), L1Decay included, exactly as
the reference's optimizer does (paddle_tpu/optimizer/optimizer.py:114-124).
"""

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __repr__(self):
        return f"{self.__class__.__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """L1 penalty by name; the optimizer applies its coefficient as L2,
    as the reference's does."""


class L2Decay(WeightDecayRegularizer):
    """L2 penalty: grad += coeff * param."""
