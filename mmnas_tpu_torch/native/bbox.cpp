// Native pairwise box-IoU kernel (TPU rebuild of mmnas/utils/bbox.pyx).
//
// The reference ships a Cython kernel compiled to C for the hot host-side
// label-building path (load_data_vgd.py:251-253 runs it per dataset item).
// This is the C++ equivalent, exposed through a C ABI for ctypes
// (mmnas_tpu/utils/bbox.py); same +1 pixel-area convention as the original
// Fast R-CNN code (bbox.pyx:33-55).
//
// Build: see mmnas_tpu/native/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>

extern "C" {

// boxes: [N,4], query: [K,4], out: [N,K]; coordinates (x1,y1,x2,y2).
void bbox_overlaps(const double* boxes, int64_t n,
                   const double* query, int64_t k,
                   double* out) {
    for (int64_t j = 0; j < k; ++j) {
        const double qx1 = query[j * 4 + 0];
        const double qy1 = query[j * 4 + 1];
        const double qx2 = query[j * 4 + 2];
        const double qy2 = query[j * 4 + 3];
        const double q_area = (qx2 - qx1 + 1.0) * (qy2 - qy1 + 1.0);
        for (int64_t i = 0; i < n; ++i) {
            const double bx1 = boxes[i * 4 + 0];
            const double by1 = boxes[i * 4 + 1];
            const double bx2 = boxes[i * 4 + 2];
            const double by2 = boxes[i * 4 + 3];
            double v = 0.0;
            const double iw = (bx2 < qx2 ? bx2 : qx2) - (bx1 > qx1 ? bx1 : qx1) + 1.0;
            if (iw > 0.0) {
                const double ih = (by2 < qy2 ? by2 : qy2) - (by1 > qy1 ? by1 : qy1) + 1.0;
                if (ih > 0.0) {
                    const double b_area = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0);
                    const double ua = b_area + q_area - iw * ih;
                    v = iw * ih / ua;
                }
            }
            out[i * k + j] = v;
        }
    }
}

// float32 batch variant used by the threaded loader: many (N,4)x(1,4)
// label computations in one call. boxes: [B,N,4], query: [B,1,4],
// out: [B,N].
void bbox_overlaps_batch_f32(const float* boxes, int64_t b, int64_t n,
                             const float* query, float* out) {
    for (int64_t bi = 0; bi < b; ++bi) {
        const float* bx = boxes + bi * n * 4;
        const float* q = query + bi * 4;
        const float q_area = (q[2] - q[0] + 1.0f) * (q[3] - q[1] + 1.0f);
        float* o = out + bi * n;
        for (int64_t i = 0; i < n; ++i) {
            float v = 0.0f;
            const float iw = (bx[i*4+2] < q[2] ? bx[i*4+2] : q[2])
                           - (bx[i*4+0] > q[0] ? bx[i*4+0] : q[0]) + 1.0f;
            if (iw > 0.0f) {
                const float ih = (bx[i*4+3] < q[3] ? bx[i*4+3] : q[3])
                               - (bx[i*4+1] > q[1] ? bx[i*4+1] : q[1]) + 1.0f;
                if (ih > 0.0f) {
                    const float area = (bx[i*4+2] - bx[i*4+0] + 1.0f)
                                     * (bx[i*4+3] - bx[i*4+1] + 1.0f);
                    v = iw * ih / (area + q_area - iw * ih);
                }
            }
            o[i] = v;
        }
    }
}

}  // extern "C"
