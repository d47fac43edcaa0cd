"""Batched-request serving example: prefill + KV-cache decode for any
decodable assigned architecture (reduced config; ``--device cpu`` on a
machine without a GPU).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        --arch mixtral-8x7b --device cpu
"""

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
