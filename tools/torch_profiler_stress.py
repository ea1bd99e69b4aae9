"""How often a ``torch.profiler`` session loses device records on this card.

    python3 tools/torch_profiler_stress.py [--sessions 150]

Runs short profiler sessions of 100 crop-kernel launches each (the shape of
chip_smoke's kernel timings) and, before every tenth, one session of 3,000
small torch launches (the shape of its path profiles). Prints every session
whose trace does not hold exactly the launches that were made. Needs one
CUDA device; builds the crop kernel on first use.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_records(torch, fn) -> int:
    """Device records in the trace of one profiler session around ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sessions", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from pyfaceanalysis_torch.ops import cuda_crop

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(args.seed)
    pyramid = torch.rand(8, 808, 1024, generator=g).to(dev)
    crops = torch.stack([torch.randint(0, hi, (512,), generator=g)
                         for hi in (8, 700, 900)], 1).int().to(dev)
    big = torch.rand(4096, 4096, generator=g).to(dev)

    def short():
        for _ in range(100):
            cuda_crop.crop_patches_kernel(pyramid, crops, (64, 64))

    def heavy():
        for _ in range(3000):
            big[:64, :64] + 1.0

    short()
    torch.cuda.synchronize()
    lost = {}
    for i in range(args.sessions):
        if i % 10 == 0:
            n = device_records(torch, heavy)
            if n != 3000:
                lost[f"heavy before {i}"] = n
        n = device_records(torch, short)
        if n != 100:
            lost[f"short {i}"] = n
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}: "
          f"{args.sessions} sessions of 100 launches, "
          f"{(args.sessions + 9) // 10} of 3000; sessions whose trace does "
          f"not hold every launch (name: records): {lost}")


if __name__ == "__main__":
    main()
