from repro_torch.data.adjacency import (
    gaussian_adjacency,
    random_sensor_coords,
    sym_norm_adjacency,
    transition_matrices,
)
from repro_torch.data.normalize import Scaler, apply_scaler, apply_scaler_device, fit_scaler
from repro_torch.data.registry import TABLE1, DatasetSpec, get_dataset_spec
from repro_torch.data.synthetic import make_token_stream, make_traffic_series

__all__ = [
    "Scaler",
    "fit_scaler",
    "apply_scaler",
    "apply_scaler_device",
    "TABLE1",
    "DatasetSpec",
    "get_dataset_spec",
    "make_traffic_series",
    "make_token_stream",
    "gaussian_adjacency",
    "random_sensor_coords",
    "sym_norm_adjacency",
    "transition_matrices",
]
