"""Containers (reference: python/paddle/fluid/dygraph/container.py —
Sequential, ParameterList, LayerList)."""

from paddle_tpu_torch.dygraph.layers import Layer


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and layers and not isinstance(layers[0], Layer):
            layers = layers[0]
        for i, item in enumerate(layers):
            if isinstance(item, (list, tuple)):
                name, layer = item
            else:
                name, layer = str(i), item
            self.add_sublayer(name, layer)

    def __getitem__(self, name):
        return self._sub_layers[str(name)]

    def __setitem__(self, name, layer):
        self.add_sublayer(str(name), layer)

    def __len__(self):
        return len(self._sub_layers)

    def forward(self, input):
        for layer in self._sub_layers.values():
            input = layer(input)
        return input


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or []):
            self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        return self._sub_layers[str(idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def append(self, layer):
        self.add_sublayer(str(len(self._sub_layers)), layer)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or []):
            self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self
