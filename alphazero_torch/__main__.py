from alphazero_torch.main import main

main()
