"""ParamAttr (reference: python/paddle/fluid/param_attr.py)."""


class ParamAttr:
    def __init__(
        self,
        name=None,
        initializer=None,
        learning_rate=1.0,
        regularizer=None,
        trainable=True,
        do_model_average=None,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if arg is False:
            return False
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        from paddle_tpu_torch.initializer import Initializer

        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")


WeightNormParamAttr = ParamAttr
