"""First check of the limb kernel on the card, and an n13 calibration.

Builds both CUDA kernels (nvcc in parallel, ptxas report), holds
limb_matmul_canon against its plain version bit for bit at the n13 extp
apply's shapes, two ragged ones and (10, 2048, 2048)^2, prints CUDA-event
times of the kernel, the plain version and a float64 matmul of one limb
pair, then times n_sea=13 Chebyshev stepping: 2 output steps of the f64
tier and 1 of the extp tier (a 1-step grid has dt = 0, so that call makes
only the t=0 energy apply and one 2-term step).

    python3 experiments/torch_limb_kernel_probe.py

Needs a CUDA device; imports no JAX.
"""
import os, sys, time, json, statistics
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch, numpy as np
from quantumsimulations_tpu_torch.kernels._build import build_all
from quantumsimulations_tpu_torch.kernels import launches
t0 = time.perf_counter()
res = build_all(("limb_matmul_canon", "cmatmul_f32"), extra_flags=("-Xptxas", "-v"))
for k, (out, sec) in res.items():
    print(k, f"{sec:.1f}s", [l.strip() for l in out.splitlines() if "registers" in l or "spill" in l], flush=True)
from quantumsimulations_tpu_torch.ops.limb_kernels import limb_matmul_canon as kmm, limb_matmul_canon_plain as plain
def ms(fn, reps=10):
    for _ in range(2): fn()
    torch.cuda.synchronize(); ts=[]
    for _ in range(reps):
        a=torch.cuda.Event(enable_timing=True); b=torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize(); ts.append(a.elapsed_time(b))
    return statistics.median(ts)
g = torch.Generator(device="cuda").manual_seed(0)
def limbs(shape):
    x = torch.randint(-32, 33, (10,)+shape, generator=g, device="cuda", dtype=torch.int32)
    x[0] = torch.randint(-64, 65, shape, generator=g, device="cuda", dtype=torch.int32)
    return x.to(torch.int8).contiguous()
ok = True
for (M,K,N,tr) in [(256,128,256,False),(1792,128,128,True),(128,1792,128,False),(33,50,70,False),(48,37,24,True),(2048,2048,2048,False)]:
    a, b = limbs((M,K)), limbs((K,N))
    kw = dict(tm=128 if M%128==0 else 16, transpose_out=tr) if tr else {}
    o = kmm(a, b, bits=6, **kw); torch.cuda.synchronize()
    p = plain(a, b, 6, **kw)
    eq = torch.equal(o, p); ok &= eq
    print((M,K,N,tr), "equal", eq, "ndiff", int((o!=p).sum()), flush=True)
    if eq:
        print("   kernel ms", ms(lambda: kmm(a,b,bits=6,**kw)), "plain ms", ms(lambda: plain(a,b,6,**kw), 3),
              "f64 mm", ms(lambda: (a[0].double() @ b[0].double())), flush=True)
if not ok: sys.exit(1)
# n13 calibration
from quantumsimulations_tpu_torch.models.dipolar import build_model
from quantumsimulations_tpu_torch.models.params import DipolarRareParams
from quantumsimulations_tpu_torch.analysis.metrics import f1R_for_resonance
from quantumsimulations_tpu_torch.dynamics import cheb_step as cs
from quantumsimulations_tpu_torch.utils.profiling import StageTimer, tracing
gs, gr = 8.1812e7, 6.976e7; B0=3.0; fAz=gs*B0/(2*np.pi); f1A=5e4; f1R=f1R_for_resonance(f1A,f1A,0.0)
def params(n):
    return DipolarRareParams(n_sea=n, gamma_sea=gs, gamma_rare=gr, B0_sea=B0, B0_rare=B0, B1_sea=2*np.pi*f1A/gs,
        B1_rare=2*np.pi*f1R/gr, omega_rf_sea=2*np.pi*fAz, omega_rf_rare=gr*B0, phi_sea=np.pi/2, phi_rare=np.pi/2,
        dipolar_scale=1e-7*1.054571817e-34, shell_scale=0.282393e-9, t_final=30.0, steps=20000, drive_sea=True,
        drive_rare=True, is_spin_three_half=False, is_center_rare=True)
t0=time.perf_counter(); m = build_model(params(13)); print("model", time.perf_counter()-t0, flush=True)
dt = 30/19999
for arith, T in (("f64", 2), ("extp", 1)):
    tm = StageTimer(device=torch.device("cuda"))
    t0=time.perf_counter()
    with tracing(tm):
        rows = cs.chebyshev_step_traces(m.hamiltonian, m.psi0, dt*np.arange(T), m.dims, m.n_sea_effective, m.idx_rare,
            arithmetic=arith, device="cuda", timer=tm)
    print(arith, T, time.perf_counter()-t0, tm.as_dict(), dict(launches(tm)), rows[:, -1].tolist(), flush=True)
