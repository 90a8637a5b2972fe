from alphazero_torch.web.server import serve

__all__ = ["serve"]
