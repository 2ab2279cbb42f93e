"""Device time of the sort formulation's permutation sorts in the traced
supervised stretch, per tick, in ms; nothing where no such kernel ran.

Under ``edge_gather_mode="sort"`` every reverse-edge exchange builds its
route with one ``torch.sort`` of the N*K destination keys
(ops/permgather.sort_permutation, the program's span ``exchange.sort``).
On the card PyTorch's stable sort fills the source indices
(``fill_reverse_indices_kernel``) and sorts the pairs with cub's
onesweep radix sort (histogram, exclusive sum, one onesweep pass per key
byte, each zeroing its counters with a memset); those kernels and the
memsets are found here by name: the memsets of a captured chunk are the
sort's (at 1,048,576 peers 39.7 us of them a tick in the stretch,
against 40.1 us inside an eager tick's ``exchange.sort`` spans). Left
out, because the trace names it as it names every other copy: a
device-to-device copy the size of the keys inside the sort (``Memcpy DtoD``),
~5% of the span's device time at 1,048,576 peers. cub's single-tile
kernel is left out too: in this tick it runs a small int64 sort outside
the span."""

# the kernels of PyTorch's stable sort over cub's onesweep radix sort, and
# the memsets ("Memset (Device)" eager, "Memset (Unknown)" in a graph)
SORT_KERNELS = ("fill_reverse_indices_kernel",
                "DeviceRadixSortHistogramKernel",
                "DeviceRadixSortExclusiveSumKernel",
                "DeviceRadixSortOnesweepKernel",
                "Memset (")


def read(ctx):
    s = (ctx.get("trace") or {}).get("stretch")
    if not s:
        return None
    us = sum(v for name, v in s["device_us"].items()
             if any(k in name for k in SORT_KERNELS))
    return us / 1e3 / s["ticks"] if us > 0 else None
