"""The accelerator-device model: memories, DMA, and the CSR launch API.

The port of `aloha_tpu/runtime/device.py`.  It mirrors the reference SoC's
host-visible surface (reference: src/top/h2_top.sv,
src/mem_buf/axil_parse.sv:50-72):

  * a 16 MiB scratchpad (SPM: 16384 rows x 1 KiB, "64 ciphertexts",
    reference: src/vp/include/vp_defines.vh:27, src/mem_buf/spm.sv)
  * a 9 MiB key-switch-key memory (reference: src/mem_buf/ksk_mem.sv)
  * DMA commands 0=KSK, 1=SPM, 2=encoder-stream
    (reference: src/mem_buf/axi_data_rd_top.sv:46-96)
  * `run_vp(pc, src0, src1, rslt, step, ksk_ptr)` kernel launches
    (reference: sim/top/top_noaxilite_tb.sv:396-417)

Both memories are int64 tensors on one device (`cuda` unless the caller
asks for another): DMA is a host <-> device copy of the words' bits, and a
launch replays the program through `TorchBackend` (the NTT and
automorphism kernels on the card).  Checkpoints are the JAX device's
format and VERSION, so a state saved by either device loads into the other.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from aloha_tpu_torch.config import DEFAULT_CONFIG, HEConfig, KSK_ROWS, NUM_LANES, SPM_ROWS
from aloha_tpu_torch.isa import programs
from aloha_tpu_torch.isa.interp import LaunchArgs, VectorProcessor
from aloha_tpu_torch.torch_backend import TorchBackend

#: Accelerator version register value (reference: axil_parse.sv:174 returns
#: 0x20230605 at offset 0x104); this re-design's, shared with the JAX device.
VERSION = 0x20260816


class AlohaDevice:
    """One accelerator instance, its memories on one torch device."""

    def __init__(
        self,
        cfg: HEConfig = DEFAULT_CONFIG,
        device=None,
        spm_rows: int = SPM_ROWS,
        ksk_rows: int = KSK_ROWS,
    ):
        self.cfg = cfg
        self.be = TorchBackend(device)
        self.device = self.be.device
        self.vp = VectorProcessor(cfg, self.be)
        self.spm = self.be.zeros((spm_rows, NUM_LANES))
        self.ksk_mem = self.be.zeros((ksk_rows, NUM_LANES))
        self.isram = programs.isram_image(cfg)
        self.poly_rows = cfg.n // NUM_LANES  # rows per polynomial (64)

    def _rows(self, data) -> torch.Tensor:
        """uint64 words (any shape), or an int64 tensor of their bits on
        any device, as (rows, 128) int64 on this device."""
        if isinstance(data, torch.Tensor):
            return self.be.wrap(data.reshape(-1, NUM_LANES))
        return self.be.wrap(np.asarray(data, dtype=np.uint64).reshape(-1, NUM_LANES))

    # ------------------------------------------------------------------ DMA
    def dma_load_ksk(self, data, row: int = 0) -> None:
        """DMA command 0: fill the KSK memory (host -> device).

        `data` is uint64 (or an int64 tensor of the same bits), any shape;
        flattened coefficient-major like the reference DDR image (3 steps x
        12 polys for the shipped testbench, reference:
        sim/top/top_noaxilite_tb.sv:372-393).
        """
        self.ksk_mem = self.be.write_rows(self.ksk_mem, row, self._rows(data))

    def dma_write_spm(self, spm_row: int, data) -> None:
        """DMA command 1: DDR -> SPM (used by load_cipher)."""
        self.spm = self.be.write_rows(self.spm, spm_row, self._rows(data))

    def dma_read_spm(self, spm_row: int, n_rows: int) -> np.ndarray:
        """SPM -> DDR (store_cipher / intermediate dumps): uint64 on the host."""
        return self.be.unwrap(
            self.be.read_rows(self.spm, spm_row, n_rows)
        ).reshape(n_rows, NUM_LANES)

    # ----------------------------------------------------------- launches
    def run_vp(
        self,
        pc: int,
        src0: int,
        src1: int,
        rslt: int,
        step: int = 0,
        ksk_ptr: int = 0,
    ) -> None:
        """Kick one VP program; returns after its vbreak (glb_done), its
        work enqueued on the device's stream."""
        args = LaunchArgs(
            pc=pc, src0=src0, src1=src1, rslt=rslt, step=step, ksk_ptr=ksk_ptr
        )
        self.spm = self.vp.run(self.isram, self.spm, self.ksk_mem, args)

    # -- op-level helpers mirroring the reference host tasks
    #    (reference: sim/top/top_noaxilite_tb.sv:522-532)
    def run_encode_post(self, dest: int, src: int) -> None:
        self.run_vp(programs.ISRAM_ENCODE_POST, src, 0, dest)

    def run_mul_plain(self, dest: int, src_ct: int, src_pt: int) -> None:
        self.run_vp(programs.ISRAM_MUL_PLAIN, src_ct, src_pt, dest)

    def run_hom_add(self, dest: int, src1: int, src2: int) -> None:
        self.run_vp(programs.ISRAM_HOM_ADD, src1, src2, dest)

    def run_rotate(self, dest: int, src: int, step: int) -> None:
        """step is the power-of-two slot rotation amount (2, 4, 8, ...).

        CSR step = 3^step mod 2N; KSK slot = (clog2(step)-1) * 12 polys
        (reference: sim/top/top_noaxilite_tb.sv:530-532).
        """
        if step < 2 or step & (step - 1):
            raise ValueError(
                f"rotation step {step} must be a power of two >= 2 "
                "(the KSK memory holds one key per power-of-two step, "
                "reference: sim/top/top_noaxilite_tb.sv:530-532)"
            )
        n = self.cfg.n
        L = self.cfg.n_limbs
        csr_step = pow(3, step, 2 * n)
        slot = math.ceil(math.log2(step)) - 1
        # one key image per power-of-two step: 2L(L+1) polys (= the
        # reference's 12-poly / 768-row stride for the 2-limb default)
        ksk_ptr = slot * 2 * L * (L + 1) * self.poly_rows
        # For L > 2 the keyswitch program spills its digit NTTs to the
        # result segment past the 2L output polys (see
        # programs._keyswitch_spill): rows [dest + 2L*polyrows,
        # dest + (2L + L(L+1) + L)*polyrows) are clobbered.
        self.run_vp(
            programs.ISRAM_KEYSWITCH, src, 0, dest, csr_step, ksk_ptr
        )

    def ksk_slot_rows(self) -> int:
        """Rows per rotation-key image: 2L(L+1) polys (the reference's
        768-row / 12-poly stride for the 2-limb default)."""
        L = self.cfg.n_limbs
        return 2 * L * (L + 1) * self.poly_rows

    def rotation_ksk_ptr(self, component: int) -> int:
        """KSK row of the key for a power-of-two rotation component.

        Components 2^k (k >= 1) follow the reference convention
        slot = k - 1 (reference: sim/top/top_noaxilite_tb.sv:530-532).
        The reference never rotates by an odd amount, so it reserves no
        slot for a step-1 key; this framework extends the layout by
        placing it in the LAST slot the KSK memory can hold (slot 11 for
        the default 9216-row memory — exactly the slot left over after
        steps 2..2048 fill slots 0..10 for the n=8192 config).
        """
        if component < 1 or component & (component - 1):
            raise ValueError(f"{component} is not a power-of-two component")
        stride = self.ksk_slot_rows()
        if component == 1:
            slot = int(self.ksk_mem.shape[0]) // stride - 1
        else:
            slot = component.bit_length() - 2
        return slot * stride

    def run_rotate_any(
        self, dest: int, src: int, step: int, scratch: Optional[int] = None
    ) -> None:
        """Slot rotation by ANY positive amount, composed from
        power-of-two keyswitches (3^a * 3^b = 3^(a+b) mod 2N, so rotating
        by each set bit of `step` in sequence rotates by `step`).

        Every needed component key must already be DMA'd to its
        `rotation_ksk_ptr` slot.  Multi-bit steps ping-pong between
        `scratch` and `dest` (both 4-poly regions, disjoint from `src`
        and from each other; for L > 2 each launch also clobbers the
        spill rows past its output — see run_rotate).  Single-bit steps
        need no scratch.
        """
        n_slots = self.cfg.n // 2
        step %= n_slots
        if step == 0:
            raise ValueError("rotation step must be nonzero mod n/2")
        comps = [1 << k for k in range(step.bit_length()) if step & (1 << k)]
        if len(comps) > 1 and scratch is None:
            raise ValueError(
                f"step {step} decomposes into {len(comps)} power-of-two "
                "keyswitches; pass a scratch region for the intermediates"
            )
        n = self.cfg.n
        cur = src
        C = len(comps)
        for i, comp in enumerate(comps, start=1):
            # work backwards from the requirement that launch C lands in
            # dest and consecutive launches never run in place
            tgt = dest if (C - i) % 2 == 0 else scratch
            self.run_vp(
                programs.ISRAM_KEYSWITCH, cur, 0, tgt,
                pow(3, comp, 2 * n), self.rotation_ksk_ptr(comp),
            )
            cur = tgt

    # ------------------------------------------------------- convenience
    def load_cipher(self, spm_row: int, flat_ct) -> None:
        """4-poly ciphertext image -> SPM (DMA command 1)."""
        self.dma_write_spm(spm_row, flat_ct)

    def store_cipher(self, spm_row: int) -> np.ndarray:
        return self.dma_read_spm(spm_row, 4 * self.poly_rows).reshape(-1)

    def load_poly(self, spm_row: int, poly) -> None:
        self.dma_write_spm(spm_row, poly)

    def store_poly(self, spm_row: int, n_polys: int = 1) -> np.ndarray:
        return self.dma_read_spm(spm_row, n_polys * self.poly_rows).reshape(-1)

    # ------------------------------------------------------ status / state
    def status(self) -> dict:
        """Host-visible status, the glb_done register's information content
        (reference: axil_parse.sv:71-72,175 packs {poly_id, vp_done,
        wr_done, rd_done}; launches here are synchronous, so done bits are
        always set between calls)."""
        return {
            "version": VERSION,
            "vp_done": True,
            "rd_done": True,
            "wr_done": True,
            "spm_rows": int(self.spm.shape[0]),
            "ksk_rows": int(self.ksk_mem.shape[0]),
        }

    def save_state(self, path) -> None:
        """Checkpoint the device memories (the reference's host-managed
        snapshot flow: any SPM region DMA'd to DDR and reloaded,
        reference: sim/top/top_noaxilite_tb.sv:498-520): uint64 arrays in
        the JAX device's npz format."""
        np.savez_compressed(
            path,
            spm=self.be.unwrap(self.spm),
            ksk_mem=self.be.unwrap(self.ksk_mem),
            version=np.uint64(VERSION),
        )

    def load_state(self, path) -> None:
        with np.load(path) as d:
            if int(d["version"]) != VERSION:
                raise ValueError(
                    f"checkpoint version 0x{int(d['version']):x} != "
                    f"device 0x{VERSION:x}"
                )
            self.spm = self.be.wrap(d["spm"])
            self.ksk_mem = self.be.wrap(d["ksk_mem"])
