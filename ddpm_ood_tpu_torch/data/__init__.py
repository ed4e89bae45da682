from .loader import DataLoader, get_training_data_loader

__all__ = ["DataLoader", "get_training_data_loader"]
